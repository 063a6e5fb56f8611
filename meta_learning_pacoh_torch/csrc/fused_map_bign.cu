// A whole PACOH-MAP training run for tasks of 9 <= N <= 512 points in one
// launch: n_steps iterations of (loss -sum_t w_t MLL_t and its gradient,
// AdamW) for one GP prior with an NN mean and an NN-featurised RBF kernel
// (any depths and widths of the two nets, D inputs, F <= 8 features).
//
// Replaces the Pallas TPU kernel meta_learning_pacoh_tpu/ops/pallas/
// fused_map_bign_kernel.py (fused_map_bign_train_packed; body _make_kernel).
// Per step and task, as the TPU kernel's body (:195-327):
//   forward   both tanh MLPs over the task's N rows; z = feature / lengthscale;
//             d2 = |z_a|^2 + |z_b|^2 - 2 z_a.z_b, Km = os exp(-0.5 max(d2, 0))
//   MLL       the bordered system of the TPU kernel (:238-247): Kn = Km m_a
//             m_b + diag(real ? noise + floor + 1e-6 : 1) with the residual r
//             as its row N, factored in 32-column panels (tiled_chol.cuh) at
//             the first jitter of (0, 1e-4, 1e-2) that succeeds, the jitter
//             on the real rows' diagonal only (eye * mask, :153), NaN where
//             no level factors; the border row comes out as z = L^-1 r, so
//             quad + logdet = |z|^2 + 2 sum log diag L needs no forward
//             substitution; W = L^-1 and K^-1 = W^T W in place
//             (tiled_inverse.cuh, :267-274), alpha = W^T z; the loss term
//             0.5 w_t (quad + logdet + n_t log 2 pi)
//   backward  score = 0.5 w (alpha_a alpha_b - K^-1_ab) (:275-299), each K^-1
//             entry read where its pair is scored, into d(mean), d(feature)
//             (a clamped d2 passes no gradient), d(lengthscale),
//             d(outputscale), d(noise); both MLPs' backward into minus the
//             task's partial gradient
//   AdamW     optax.adamw with float32 bias corrections (csrc/map_nets.cuh,
//             shared with B6) on the sum of the partials.
//
// What bounds it on the card: at bench.py's map_t5_n200 (T=5, N=200, D=1,
// nets 32x32, F=2, P=2343) a step needs per task about N^3/3 flops for the
// factor, N^3/3 for the inverse and N^3/3 for K^-1 with about 2.6 MFLOP of
// MLP products: about 55 MFLOP a step, under 1 us of the card's f32 rate.
// One block a task (5 of 132 SMs) walks its system through the panels of
// tiled_chol.cuh and tiled_inverse.cuh (register micro-tiles, a few barriers
// a panel), so what is left is each phase's longest per-thread chain (the
// diagonal tile's pivots, the deepest micro-tile) rather than the two
// barriers a column of the first design (a column at a time, 77% of its
// step). The nets run in register tiles over activations held [H][N | 1]
// (map_tiles.cuh) where every width is a multiple of 4, else in
// map_nets.cuh's scalar passes. The task's packed matrix and both nets'
// activations live in shared memory where they fit beside the parameters
// (map_t5_n200 does: placement 2), else the activations and then the
// matrix move to the block's region of a device scratch (in L2). The tasks
// go to at most 128 blocks, a block walking its tasks in order, so every
// block is resident for the grid barriers (cooperative launch). A step:
// every block's partial gradient and loss, its tasks' summed in task order
// (an undrawn task's system is skipped), into its row of a [G, P + 1]
// scratch, a grid barrier, a fixed-order reduction over the G rows and
// AdamW split over the blocks, a second barrier. Parameters too wide for
// shared memory beside the system live in the block's region of a device
// scratch. No float atomics, so any split into launches gives the same bits.

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
constexpr int kMapTiles = 16;  // diagonal tiles of the largest system, N = 512

#include "tiled_chol.cuh"
#include "tiled_inverse.cuh"
#include "map_nets.cuh"
#include "map_tiles.cuh"

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
  float* gbuf;          // [G, P + 1] scratch: the blocks' partial loss gradients and losses
  float* gtask;         // [G, P + 1] scratch: one task's, with several tasks a block (else null)
  float* th_dev;        // [G, P] scratch: the parameters, when not in shared memory (else null)
  float* act;           // [G, (sum_hm + sum_hk) (N | 1)] scratch: activations, if not shared
  float* work;          // [G, N, N] scratch: the task's matrix, when not in shared memory
  float* loss_out;      // [2] last step's loss, sum of the launch's losses
  int t, n, d, f, lm, lk, sum_hm, sum_hk, p, n_steps, groups, tpb;
  int shared;           // in shared memory: 0 neither, 1 the matrix, 2 it and the activations
  int tiled;            // 1 map_tiles.cuh's passes, 0 map_nets.cuh's
  int th_shared;        // 1 the parameters in shared memory, 0 in th_dev
  float step0, lr, wd, noise_floor;
};

// Shared-memory floats of a task's rows and per-point vectors (xs, ys, ms,
// outm, outk, rv, al, sq, the border row when the matrix is in device
// memory) and of sp_ls, hyp and the tile logs.
__host__ __device__ __forceinline__ size_t vector_floats(int n, int d, int f) {
  return static_cast<size_t>(n) * (d + f + 7) + 2 * f + 4 + kMapTiles;
}

// Shared-memory floats of one block; ops/cuda/fused_map_bign_kernel.py
// (smem_bytes) states the same count. The per-row partials [N][2F + 2] of
// the score loop live in the tiled scratch, free by then.
size_t smem_floats(int n, int d, int f, int p, int sum_h, int shared, int th_shared) {
  return (shared ? tiled_packed_floats(n, n + 1) : tiled_scratch_floats(n, n + 1)) +
         (th_shared ? static_cast<size_t>(p) : 0) + vector_floats(n, d, f) +
         (shared == 2 ? static_cast<size_t>(sum_h) * (n | 1) : 0);
}

// The work areas of one task's system: shared memory, except, where they do
// not fit there, the activations and the matrix.
struct MapWork {
  float* xs;     // [N][D] the task's inputs
  float* ys;     // [N] its targets
  float* ms;     // [N] its mask
  float* outm;   // [N] mean-net output, then d(mean)
  float* outk;   // [N][F] kernel-net features, then d(feature)
  float* rv;     // [N] residual
  float* al;     // [N] K^-1 r
  float* sq;     // [N] |z_a|^2
  float* sp_ls;  // [F] softplus(lengthscale)
  float* hyp;    // [F + 3] d(softplus ls) [F], os d(softplus os), d(noise), -w ll
  float* sums;   // [kMapTiles + 1] the diagonal tiles' sum log L_cc, then |z|^2
  float* tws;    // tiled_scratch_floats(N, N + 1); the score loop's rows [N][2F + 2] after
  TiledMatrix M;  // N rows and the border row: packed in shared memory, or the
                  // square (ld = N) in device memory with the border in [N]
  float* act_m;  // mean-net activations, sum_hm x (N | 1)
  float* act_k;  // kernel-net activations, sum_hk x (N | 1)
};

// d2 of rows a and b of z [N][F] (sq the rows' |z|^2) by the expansion the
// TPU kernel and ops/kernels.sq_dists use; symmetric to the bit.
__device__ __forceinline__ float d2_of(const float* z, const float* sq, int F, int a, int b) {
  float dot = 0.f;
  for (int c = 0; c < F; ++c) dot += z[a * F + c] * z[b * F + c];
  return (sq[a] + sq[b]) - 2.f * dot;
}

// One drawn task's weighted MLL and its gradient, by the whole block. On
// entry k.outm holds the task's mean-net outputs [N] and k.outk its features
// [N][F]; on exit they hold d(w ll)/d(mean) and d(w ll)/d(feature), and
// k.hyp [F + 3] the task's d/d(softplus lengthscale) [F], d/d(softplus
// outputscale) times the outputscale, d/d(noise) and its loss term -w ll.
// Ends with a barrier.
__device__ __noinline__ void map_task_grad(int N, int F, float sp_os, float diag_add, float w,
                                           const MapWork& k) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nth >> 5;
  const TiledMatrix M = k.M;  // its fields in registers
  float* mu = k.outm;
  float* ph = k.outk;
  const float* msk = k.ms;
  // features -> z = feature / lengthscale, in place, and |z|^2; the masked residual
  for (int i = tid; i < N; i += nth) {
    float s = 0.f;
    for (int c = 0; c < F; ++c) {
      const float zc = ph[i * F + c] / k.sp_ls[c];
      ph[i * F + c] = zc;
      s += zc * zc;
    }
    k.sq[i] = s;
    k.rv[i] = (k.ys[i] - mu[i]) * msk[i];
  }
  __syncthreads();

  // the bordered system at the first jitter level that factors, a warp a row
  bool ok = false;
  for (int level = 0; level < 3 && !ok; ++level) {
    const float jit = level == 0 ? 0.f : (level == 1 ? 1e-4f : 1e-2f);
    for (int i = warp; i <= N; i += n_warps) {
      float* row = M.row(i);
      if (i == N) {
        for (int c = lane; c < N; c += 32) row[c] = k.rv[c];
        continue;
      }
      for (int c = lane; c <= i; c += 32) {
        float v = sp_os * expf(-0.5f * fmaxf(d2_of(ph, k.sq, F, i, c), 0.f)) * msk[i] * msk[c];
        if (i == c) {
          if (msk[i] > 0.f) {
            v += diag_add;
            v += jit;
          } else {
            v += 1.f;
          }
        }
        row[c] = v;
      }
    }
    __syncthreads();
    ok = tiled_factor(M, 0.f, k.tws);
  }
  if (!ok) {  // no level factors: NaN, as the TPU kernel's last level gives
    for (int i = warp; i <= N; i += n_warps)
      for (int c = lane; c <= min(i, N - 1); c += 32) M.row(i)[c] = nanf("");
    __syncthreads();
  }
  const float* z = M.row(N);  // the border row: z = L^-1 r
  tiled_invert(M, k.tws, k.sums);
  tiled_wt_times(M, z, k.al);
  if (warp == n_warps - 1) {  // |z|^2 beside the last barrier's work
    float q = 0.f;
    for (int i = lane; i < N; i += 32) q += z[i] * z[i];
    q = warp_total(q);
    if (lane == 0) k.sums[kMapTiles] = q;
  }
  if (warp == n_warps - 2) {  // n_eff
    float q = 0.f;
    for (int i = lane; i < N; i += 32) q += msk[i];
    q = warp_total(q);
    if (lane == 0) k.hyp[F + 2] = q;
  }
  tiled_lauum(M);
  const float* al = k.al;
  for (int i = tid; i < N; i += nth) mu[i] = w * al[i] * msk[i];

  // a warp per row a, lanes along the columns b: score_ab and its chains,
  // (K^-1)_ab from the lower triangle, row a for b <= a, row b for b > a
  const int stride = 2 * F + 2;
  float* rowp = k.tws;
  for (int a = warp; a < N; a += n_warps) {
    const float ma = msk[a], al_a = al[a], sq_a = k.sq[a];
    const float* row_a = M.row(a);
    float za[kMaxF], dz[kMaxF];
#pragma unroll
    for (int c = 0; c < kMaxF; ++c) {
      za[c] = c < F ? ph[a * F + c] : 0.f;
      dz[c] = 0.f;
    }
    float dos = 0.f, dn = 0.f;
    for (int b = lane; b < N; b += 32) {
      const float kinv = b <= a ? row_a[b] : M.row(b)[a];
      const float s = 0.5f * w * (al_a * al[b] - kinv);
      const float dkm = s * ma * msk[b];
      if (b == a) dn += s * ma;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxF; ++c)
        if (c < F) dot += za[c] * ph[b * F + c];
      const float d2 = (sq_a + k.sq[b]) - 2.f * dot;
      const float km = sp_os * expf(-0.5f * fmaxf(d2, 0.f));
      dos += dkm * km;
      const float dd2 = d2 > 0.f ? -0.5f * dkm * km : 0.f;
#pragma unroll
      for (int c = 0; c < kMaxF; ++c)
        if (c < F) dz[c] += 4.f * dd2 * (za[c] - ph[b * F + c]);
    }
    dos = warp_total(dos);
    dn = warp_total(dn);
#pragma unroll
    for (int c = 0; c < kMaxF; ++c)
      if (c < F) dz[c] = warp_total(dz[c]);
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
  for (int e = tid; e < N * F; e += nth) ph[e] = rowp[(e / F) * stride + e % F] / k.sp_ls[e % F];
  if (tid < F + 2) {  // the task's hyperparameter sums over its rows, in order
    float s = 0.f;
    for (int a = 0; a < N; ++a) s += rowp[a * stride + F + tid];
    k.hyp[tid] = tid < F ? s / k.sp_ls[tid] : s;
  }
  if (tid == F + 2) {
    float ql = k.sums[kMapTiles];
    for (int t = 0; t * kTile < N; ++t) ql += 2.f * k.sums[t];
    k.hyp[F + 2] = 0.5f * w * (ql + k.hyp[F + 2] * kLog2Pi);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) fused_map_bign_kernel(Params q) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int T = q.t, N = q.n, D = q.d, F = q.f, P = q.p;
  const int tid = threadIdx.x, nth = blockDim.x, blk = blockIdx.x;
  const int t0 = blk * q.tpb, t1 = min(T, t0 + q.tpb);  // this block's tasks
  const int ld = N | 1;

  float* tws = smem;                                  // the tiled matrix's scratch
  float* tri = tws + tiled_scratch_floats(N, N + 1);  // its packed rows, when held here
  float* th_s = tri + (q.shared ? packed_off(N + 1) : 0);  // [P] the parameters, when held here
  float* th = q.th_shared ? th_s : q.th_dev + static_cast<size_t>(blk) * P;
  float* xs = th_s + (q.th_shared ? P : 0);          // [N][D]
  float* ys = xs + N * D;                             // [N]
  float* ms = ys + N;                                 // [N]
  float* outm = ms + N;                               // [N]
  float* outk = outm + N;                             // [N][F]
  float* rv = outk + N * F;                           // [N]
  float* al = rv + N;                                 // [N]
  float* sq = al + N;                                 // [N]
  float* border = sq + N;                             // [N] the border row, matrix in device memory
  float* sp_ls = border + N;                          // [F]
  float* hyp = sp_ls + F;                             // [F + 3]
  float* sums = hyp + F + 3;                          // [kMapTiles + 1]
  float* act_s = sums + kMapTiles + 1;                // the activations, when held here
  const TiledMatrix mat{q.shared ? tri : q.work + static_cast<size_t>(blk) * N * N,
                        q.shared ? nullptr : border, N, N + 1, q.shared != 0};
  float* act_m = q.shared == 2 ? act_s
                               : q.act + static_cast<size_t>(blk) * (q.sum_hm + q.sum_hk) * ld;
  const MapWork k{xs, ys, ms, outm, outk, rv, al, sq, sp_ls, hyp, sums, tws, mat,
                  act_m, act_m + static_cast<size_t>(q.sum_hm) * ld};

  const int* o_m = q.offs;
  const int* o_k = q.offs + 2 * q.lm + 2;
  const int* wd_m = q.widths;
  const int* wd_k = q.widths + q.lm;
  const int off_ls = o_k[2 * q.lk + 2], off_os = o_k[2 * q.lk + 3], off_nz = o_k[2 * q.lk + 4];
  const TileNet nets[2] = {{o_m, wd_m, q.lm, 1, k.act_m, outm},
                           {o_k, wd_k, q.lk, F, k.act_k, outk}};

  for (int c = tid; c < P; c += nth) th[c] = q.theta[c];
  __syncthreads();

  float loss_sum = 0.f, loss = 0.f;  // kept by thread 0 of block 0
  for (int it = 0; it < q.n_steps; ++it) {
    if (tid < F) sp_ls[tid] = softplus(th[off_ls + tid]);
    const float sp_os = softplus(th[off_os]);
    const float diag_add = softplus(th[off_nz]) + q.noise_floor + 1e-6f;
    // the block's tasks in order; with several, each into gtask, then summed
    float* gsum = q.gbuf + static_cast<size_t>(blk) * (P + 1);
    float* gb = q.gtask != nullptr ? q.gtask + static_cast<size_t>(blk) * (P + 1) : gsum;
    bool any = false;
    for (int t = t0; t < t1; ++t) {
      float w = q.w_t[t];
      if (q.counts != nullptr) {
        const float c = q.counts[static_cast<size_t>(it) * T + t];
        w = c > 0.f ? w * c : 0.f;
      }
      if (w == 0.f) continue;  // a task not drawn this step, or an empty one, adds exactly 0
      for (int c = tid; c < N * D; c += nth) xs[c] = q.x[static_cast<size_t>(t) * N * D + c];
      for (int c = tid; c < N; c += nth) {
        ys[c] = q.y[static_cast<size_t>(t) * N + c];
        ms[c] = q.mask[static_cast<size_t>(t) * N + c];
      }
      __syncthreads();
      if (q.tiled) {
        tile_nets_forward(th, nets, xs, D, N, ld);
      } else {
        net_forward(th, o_m, wd_m, q.lm, 1, xs, D, N, ld, k.act_m, outm);
        net_forward(th, o_k, wd_k, q.lk, F, xs, D, N, ld, k.act_k, outk);
        __syncthreads();
      }
      map_task_grad(N, F, sp_os, diag_add, w, k);
      if (q.tiled) {
        tile_nets_backward(th, nets, xs, D, N, ld, gb);
      } else {
        net_backward(th, o_m, wd_m, q.lm, 1, xs, D, N, ld, k.act_m, outm, gb);
        net_backward(th, o_k, wd_k, q.lk, F, xs, D, N, ld, k.act_k, outk, gb);
      }
      if (tid <= F + 2) {  // the hyperparameters' gradients and the task's loss
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
      __syncthreads();
      if (gb != gsum) {
        for (int c = tid; c <= P; c += nth) gsum[c] = any ? gsum[c] + gb[c] : gb[c];
        __syncthreads();
      }
      any = true;
    }
    if (!any)
      for (int c = tid; c <= P; c += nth) gsum[c] = 0.f;
    grid.sync();

    // reduce my coordinates over the G partials in block order; AdamW
    const float step_loss = adamw_split(q.gbuf, q.groups, P, th, q.theta, q.m, q.v,
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
                                    float* gbuf, float* gtask, float* th_dev, float* act,
                                    float* work, float* loss_out, int t, int n, int d, int f,
                                    int lm, int lk, int sum_hm, int sum_hk, int p, int n_steps,
                                    int groups, int tpb, int shared, int tiled, int th_shared,
                                    float step0, float lr, float wd, float noise_floor,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the score loop's rows [N][2F + 2] must fit the tiled scratch
  if (n < kMinN || n > kMaxN || f < 1 || f > kMaxF || t < 1 || d < 1 || lm < 1 || lk < 1 ||
      sum_hm < lm || sum_hk < lk || p < 1 || n_steps < 1 || groups < 1 || groups > kMaxGroups ||
      tpb < 1 || groups * tpb < t || (groups - 1) * tpb >= t || shared < 0 || shared > 2 ||
      (!shared && work == nullptr) || (shared < 2 && act == nullptr) ||
      (tpb > 1 && gtask == nullptr) || (!th_shared && th_dev == nullptr) ||
      static_cast<size_t>(n) * (2 * f + 2) > tiled_scratch_floats(n, n + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = smem_floats(n, d, f, p, sum_hm + sum_hk, shared, th_shared) * sizeof(float);
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

  Params q{theta, m, v, x, y, mask, w_t, counts, offs, widths, gbuf, tpb > 1 ? gtask : nullptr,
           th_shared ? nullptr : th_dev, act, work, loss_out, t, n, d, f, lm, lk, sum_hm, sum_hk,
           p, n_steps, groups, tpb, shared, tiled, th_shared, step0, lr, wd, noise_floor};
  void* args[] = {&q};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_map_bign_kernel),
                                    dim3(groups), dim3(kThreads), args, bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
