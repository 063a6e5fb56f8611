// A whole PACOH-SVGD training run for tasks of 9 <= N <= 256 points in one
// launch: n_steps iterations of (particle scores, Stein transport, Adam) for
// K particles of a GP prior with an NN mean and an NN kernel (feature_dim
// 1, L hidden layers of width H), on T tasks.
//
// Replaces the Pallas TPU kernel meta_learning_pacoh_tpu/ops/pallas/
// fused_svgd_bign_kernel.py (fused_svgd_bign_train_packed; body
// _make_kernel with make_bign_score_section and make_transport_section).
// Per step, over the G = K*T systems g = k*T + t:
//   score     each system's MLL gradient (bign_score.cuh, shared with the
//             big-N VI kernel): both MLPs of particle k over task t's rows,
//             the tiled factorization of its N x N matrix with the jitter
//             on the real rows only, the hand-derived backward; summed over
//             the particle's T systems in order, plus the hyper-prior term
//             pf * -(theta - loc) / scale^2
//   transport RBF kernel at gamma = 1 / (1e-8 + med / log(K+1)), med the
//             pairwise squared distance at rank K*K/2 (exact selection)
//   Adam      on g = -phi, bias corrections 1 - exp(t log b) in float32
// (the median, transport and Adam: fused_update.cuh, shared with B2).
//
// What bounds it on the card: at bench.py's svgd_t5_n200 (K=10, T=5,
// N=200, nets 32x32, P=2308) a step needs per system about N^3/3 flops for
// the factor, N^3/3 for the inverse and N^3/3 for K^-1, with the Gram
// matrix's chains and 2.6 MFLOP of MLP products about 0.6 GFLOP a step, 9
// us at the card's f32 rate. One block a system (50 of 132 SMs) walks its
// system through the 32-column panels of tiled_chol.cuh (the residual as
// the border row, so z = L^-1 r needs no forward substitution) and
// tiled_inverse.cuh (W = L^-1 and K^-1 = W^T W in place, register
// micro-tiles, a few barriers a panel), then the score loop reads each K^-1
// entry once; the nets run in register tiles over activations held
// [H][N | 1]. What is left is each phase's longest per-thread chain (the
// deepest micro-tile, the diagonal tile's pivots) rather than a barrier a
// column; the 50 systems run side by side. The system's packed matrix and
// both nets' activations live in shared memory when they fit beside the
// parameters (N=200 does: placement 2), else the activations and then the
// matrix move to the block's region of a device scratch (in L2). A block
// walks its systems in order, and every block is resident for the grid
// barriers (cooperative launch): one block of 512 threads an SM, the
// systems in at most 128 blocks; or, where the systems outnumber the SMs, N
// is small and two blocks' shared memory fits an SM (cauchy_20: 200
// systems of N=20), two blocks of 256 threads an SM, ceil(G / 264) systems
// each, so that two systems' short, latency-bound chains of phases run side
// by side on an SM. The width is the launch's (svgd_bign_plan in
// ops/cuda/fused_svgd_bign_kernel.py): every phase strides over blockDim.x,
// and __launch_bounds__(512) keeps the register budget at 128 a thread,
// which two 256-thread blocks an SM allow.
// A step: every block computes a share of the K x K squared distances of
// the step's particles and its systems' partial gradients into a [G, P]
// scratch; a grid barrier; every block selects the same median, forms the
// K x K kernel matrix, and takes a share of the K*P coordinates: the
// coordinate's K scores (each a fixed-order sum of T partials plus the
// prior term, the same bits in every block), its transport and Adam, into
// the other half of a particle buffer double-buffered by step parity; a
// second grid barrier. No float atomics, so any split into launches gives
// the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;  // the widest block; the launch takes 512 or 256
constexpr int kMinN = 9;
constexpr int kMaxN = 256;
constexpr int kMaxK = 32;

#include "tiled_chol.cuh"
#include "tiled_inverse.cuh"
#include "map_nets.cuh"
#include "fused_update.cuh"
#include "bign_score.cuh"

struct Params {
  float* theta;         // [K, P] in/out
  float* m;             // [K, P] in/out
  float* v;             // [K, P] in/out
  const float* x;       // [T, N, D]
  const float* y;       // [T, N]
  const float* mask;    // [T, N]
  const float* w_t;     // [T] pre / n_eff, 0 for an empty task
  const float* counts;  // [n_steps, T] task-draw counts, or null
  const float* prior_loc;    // [P]
  const float* prior_scale;  // [P]
  const int* offs;      // leaf offsets (bign_score.cuh)
  const int* widths;    // [2L] hidden widths
  float* gbuf;          // [G, P] scratch: minus the systems' partial gradients
  float* act;           // [blocks, 2 L H (N | 1)] scratch: MLP activations, unless held in shared memory
  float* work;          // [blocks, N, N] scratch: the matrix, when not in shared memory
  float* th_buf;        // [2, K, P] scratch: the particles by step parity
  float* d2;            // [K, K] scratch
  // shared: 0 the matrix and the activations in device memory, 1 the
  // matrix in shared memory, 2 both
  int k, t, n, d, h, l, p, n_steps, blocks, spb, shared;
  float step0, lr, pf, log_kp1;
};

// Shared-memory floats of one block; ops/cuda/fused_svgd_bign_kernel.py
// (smem_bytes) states the same count.
size_t smem_floats(int k, int n, int d, int p, int h, int l, int shared) {
  return bign_matrix_floats(n, shared) + static_cast<size_t>(p) + bign_vector_floats(n, d) +
         2 * static_cast<size_t>(k) * k + k + 1 + bign_act_floats(n, h, l, shared);
}

__global__ void __launch_bounds__(kThreads) fused_svgd_bign_kernel(Params q) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int K = q.k, T = q.t, N = q.n, D = q.d, L = q.l, P = q.p;
  const int G = K * T, KP = K * P, kk = K * K;
  const int tid = threadIdx.x, nth = blockDim.x, blk = blockIdx.x, n_blk = gridDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nth >> 5;

  float* tws = smem;                // the tiled matrix's scratch
  float* tri = tws + tiled_scratch_floats(N, N + 1);  // its packed rows, when held here
  float* th = tri + (q.shared ? packed_off(N + 1) : 0);  // [P] the system's particle
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
  float* d2s = sums + kMaxTiles + 4;  // [K*K]
  float* kws = d2s + kk;            // [K*K] the RBF kernel matrix
  float* rsum = kws + kk;           // [K] its row sums
  float* scal = rsum + K;           // [1]
  float* act_s = scal + 1;          // [2][L][H][N | 1] the activations, when held here
  const TiledMatrix mat{q.shared ? tri : q.work + static_cast<size_t>(blk) * N * N,
                        q.shared ? nullptr : border, N, N + 1, q.shared != 0};
  float* act_m = q.shared == 2 ? act_s : q.act + blk * bign_act_size(N, q.h, L);
  const BignWork work{xs, ys, ms, outm, outk, rv, al, rowp, hyp, sums, tws, mat,
                      act_m, act_m + bign_act_size(N, q.h, L) / 2};

  // the particles into the step buffer of parity 0
  for (int e = blk * nth + tid; e < KP; e += n_blk * nth) q.th_buf[e] = q.theta[e];
  grid.sync();

  const int g0 = blk * q.spb, g1 = min(G, g0 + q.spb);
  for (int it = 0; it < q.n_steps; ++it) {
    const int par = it & 1;
    const float* th_all = q.th_buf + static_cast<size_t>(par) * KP;
    float* th_next = q.th_buf + static_cast<size_t>(par ^ 1) * KP;

    // ---- a share of the pairwise squared distances, a warp a pair a <= b,
    // written to both halves so that d2 is exactly symmetric
    for (int pr = blk * n_warps + warp; pr < kk; pr += n_blk * n_warps) {
      const int a = pr / K, b = pr % K;
      if (b < a) continue;
      float acc = 0.f;
      for (int c = lane; c < P; c += 32) {
        const float dv = __ldcg(th_all + static_cast<size_t>(a) * P + c) -
                         __ldcg(th_all + static_cast<size_t>(b) * P + c);
        acc += dv * dv;
      }
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        q.d2[a * K + b] = acc;
        q.d2[b * K + a] = acc;
      }
    }

    // ---- the block's systems, in order: minus their partial gradients
    for (int g = g0; g < g1; ++g) {
      const int pk = g / T, t = g % T;
      float w = q.w_t[t];
      if (q.counts != nullptr) {
        const float c = q.counts[static_cast<size_t>(it) * T + t];
        w = c > 0.f ? w * c : 0.f;
      }
      for (int c = tid; c < P; c += nth) th[c] = __ldcg(th_all + static_cast<size_t>(pk) * P + c);
      for (int c = tid; c < N * D; c += nth) xs[c] = q.x[static_cast<size_t>(t) * N * D + c];
      for (int c = tid; c < N; c += nth) {
        ys[c] = q.y[static_cast<size_t>(t) * N + c];
        ms[c] = q.mask[static_cast<size_t>(t) * N + c];
      }
      __syncthreads();
      bign_system(th, q.offs, q.widths, L, N, D, w, q.gbuf + static_cast<size_t>(g) * P, work);
    }
    grid.sync();

    // ---- every block: the median (rank K*K/2) and the K x K kernel matrix
    for (int c = tid; c < kk; c += nth) d2s[c] = __ldcg(q.d2 + c);
    const float gamma = rbf_gamma(median_upper(d2s, kk, scal), q.log_kp1);
    for (int c = tid; c < kk; c += nth) kws[c] = expf(-gamma * d2s[c]);
    __syncthreads();
    if (tid < K) {
      float s = 0.f;
      for (int j = 0; j < K; ++j) s += kws[tid * K + j];
      rsum[tid] = s;
    }
    __syncthreads();

    // ---- a share of the K*P coordinates: K scores, transport, Adam
    const float t_f = q.step0 + static_cast<float>(it) + 1.f;
    const float bc1 = 1.f - expf(t_f * kLogB1);
    const float bc2 = 1.f - expf(t_f * kLogB2);
    const float two_gamma = 2.f * gamma;
    for (int e = blk * nth + tid; e < KP; e += n_blk * nth) {
      const int pk = e / P, c = e % P;
      const float loc = q.prior_loc[c], scale = q.prior_scale[c];
      const auto particle = [&](int j) { return __ldcg(th_all + static_cast<size_t>(j) * P + c); };
      const auto score = [&](int j) {
        float s = 0.f;
        for (int t = 0; t < T; ++t) s += __ldcg(q.gbuf + static_cast<size_t>(j * T + t) * P + c);
        return -s + q.pf * (-(particle(j) - loc) / (scale * scale));
      };
      float m = q.m[e], v = q.v[e];
      th_next[e] = transport_adam(kws + pk * K, K, rsum[pk], two_gamma, particle(pk), score,
                                  particle, m, v, q.lr, bc1, bc2);
      q.m[e] = m;
      q.v[e] = v;
    }
    grid.sync();
  }

  // the block's own coordinates of the last step
  const float* th_last = q.th_buf + static_cast<size_t>(q.n_steps & 1) * KP;
  for (int e = blk * nth + tid; e < KP; e += n_blk * nth) q.theta[e] = th_last[e];
}

}  // namespace

extern "C" int pacoh_fused_svgd_bign(float* theta, float* m, float* v, const float* x,
                                     const float* y, const float* mask, const float* w_t,
                                     const float* counts, const float* prior_loc,
                                     const float* prior_scale, const int* offs,
                                     const int* widths, float* gbuf, float* act, float* work,
                                     float* th_buf, float* d2, int k, int t, int n, int d, int h,
                                     int l, int p, int n_steps, int blocks, int spb, int shared,
                                     int threads, float step0, float lr, float pf, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g = k * t;
  if (k < 1 || k > kMaxK || n < kMinN || n > kMaxN || t < 1 || d < 1 || h < 1 || l < 1 ||
      p < 1 || n_steps < 1 || blocks < 1 || spb < 1 || blocks * spb < g ||
      (blocks - 1) * spb >= g || shared < 0 || shared > 2 || (!shared && work == nullptr) ||
      (shared < 2 && act == nullptr) || (threads != kThreads && threads != kThreads / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = smem_floats(k, n, d, p, h, l, shared) * sizeof(float);
  if (bytes > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(fused_svgd_bign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // every block must be resident at once for the grid barrier
  int per_sm = 0, n_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_svgd_bign_kernel, threads,
                                                      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm * n_sm < blocks) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);

  Params q{theta, m, v, x, y, mask, w_t, counts, prior_loc, prior_scale, offs, widths, gbuf, act,
           work, th_buf, d2, k, t, n, d, h, l, p, n_steps, blocks, spb, shared, step0, lr, pf,
           static_cast<float>(log(static_cast<double>(k + 1)))};
  void* args[] = {&q};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_svgd_bign_kernel),
                                    dim3(blocks), dim3(threads), args, bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
