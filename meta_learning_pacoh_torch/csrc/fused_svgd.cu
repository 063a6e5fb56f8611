// A whole PACOH-SVGD training run in one launch: n_steps iterations of
// (particle score, Stein transport, Adam) for K particles of a GP prior with
// an NN mean and an NN kernel (feature_dim 1, L hidden layers of width H),
// on T tasks of N <= 8 points.
//
// Replaces the Pallas TPU kernel meta_learning_pacoh_tpu/ops/pallas/
// fused_train_kernel.py (fused_svgd_train_packed; body _make_kernel with
// make_score_section, make_transport_section and the optax-exact Adam).
// Per step and particle:
//   score     the GP prior's score section (cluster_score.cuh, shared with
//             the fused VI kernel): both MLPs forward, the per-task MLL and
//             its gradient, both MLPs' backward; then the hyper-prior term
//             pf * -(theta - loc) / scale^2
//   transport RBF kernel at gamma = 1 / (1e-8 + med / log(K+1)), med the
//             pairwise squared distance at rank K*K/2 (exact selection)
//   Adam      on g = -phi, bias corrections 1 - exp(t log b) in float32
// (the median, transport and Adam: fused_update.cuh, shared with the big-N
// kernel fused_svgd_bign.cu).
//
// What bounds it on the card: at sin_20 (K=10, T=20, N=5, H=32, P=2308) a
// step is about 13 MFLOP of MLP products and a few thousand flops of 5x5
// linear algebra a task, so neither HBM bytes nor the card's flops bound
// it: latency does. With one block a particle (this kernel's first design)
// a clock64() profile of block 0 found the MLP passes 69% of its cycles (each
// thread one output at a time, two shared loads a multiply-add, 10 of 132
// SMs), the transport 13%, the distances, median and two grid barriers 15%,
// the per-task MLL 3%. With clusters of 8 (80 CTAs) a step takes about 36k
// cycles of block 0, 18 us (H100 80GB HBM3, 700 W): both MLP passes 38%,
// the four barriers (three cluster, one grid) 19%, the distances and their
// staging 14%, the per-task MLL 6%.
// The design: one thread-block cluster of C CTAs a particle (C from
// ops/cuda/fused_svgd_kernel.py's cluster_plan; K*C CTAs on as many SMs).
// Every CTA holds the particle whole in shared memory, owns a contiguous
// group of tasks (their rows' forward, MLL and backward, in register tiles)
// and a slice of P: the cluster sums the CTAs' partial scores slice by slice
// in rank order over distributed shared memory, each CTA adds the
// hyper-prior term to its slice and publishes the slice and the particle's
// coordinates to an L2-resident scratch, double-buffered by step parity. One
// grid barrier a step (cooperative launch): then every cluster computes the
// whole K x K matrix of squared distances, each CTA over its slice for
// every pair (the K particles' and scores' slices staged in shared memory by
// cp.async, one (pair, segment) sum a thread) and the cluster's sum in rank
// order, so every cluster holds the same exactly symmetric matrix and
// selects the same median. Each CTA
// transports and Adam-updates its slice (the Adam moments in device memory,
// touched once a step) and gathers the other slices of its particle over
// distributed shared memory. Double buffering stays safe with one grid
// barrier: a CTA overwrites buffer `par` at step it+2 only after passing the
// barrier of step it+1, which every CTA reaches only after reading step it's.
// No float atomics: every sum has one fixed order, so results are
// bit-identical however a run is split into launches. Where a CTA's rows do
// not fit beside the rest (many tasks), it walks them in tiles of the plan's
// `tile` tasks (cluster_score.cuh), with the bits of one pass over them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cluster_score.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxK = 32;
constexpr int kMaxN = 8;
constexpr size_t kMaxSmem = 232448;
constexpr size_t kSegParts = 2 * kClusterThreads;  // partial distances of a chunk's segments
// Adam constants as optax forms them in float32 from Python doubles
constexpr float kB1 = 0.9f, kB2 = 0.999f, kEps = 1e-8f;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kLogB1 = static_cast<float>(-0.10536051565782628);   // log(0.9)
constexpr float kLogB2 = static_cast<float>(-0.0010005003335835335); // log(0.999)

#include "fused_update.cuh"

struct Params {
  float* theta;  // [K, P] in/out
  float* m;      // [K, P] in/out
  float* v;      // [K, P] in/out
  const float* x;       // [T, N, D]
  const float* y;       // [T, N]
  const float* mask;    // [T, N]
  const float* w_t;     // [T] pre / n_eff, 0 for empty tasks
  const float* counts;  // [n_steps, T] task-draw counts, or null
  const float* prior_loc;    // [P]
  const float* prior_scale;  // [P]
  const int* offs;      // leaf offsets (cluster_score.cuh)
  float* th_buf;        // [2, K, P] scratch
  float* s_buf;         // [2, K, P] scratch
  int k, t, n, d, h, l, p, n_steps;
  int c;                // CTAs a cluster
  int hs;               // row stride of the activations, H or H + 1
  int ch;               // coordinates a chunk of the staging
  int tile;             // tasks a tile; >= ceil(T / C): the CTA's rows held whole
  float step0, lr, pf, log_kp1;
};

// Row pitch of the staging for chunks of ch coordinates: 4 mod 32 for
// 16-byte rows (so rows of one coordinate fall in 8 bank groups), odd
// otherwise; ops/cuda/fused_svgd_kernel.py (stash_pitch) states the same.
__host__ __device__ __forceinline__ int stash_pitch(int ch) {
  return ch % 4 == 0 ? ch + (36 - ch % 32) % 32 : (ch | 1);
}

// Shared-memory floats of one CTA, its rows those of `tile` tasks at most;
// ops/cuda/fused_svgd_kernel.py (smem_bytes) states the same count.
size_t smem_floats(int k, int t, int n, int d, int l, int p, int c, int hs, int ch, int tile) {
  const int groups = (t + c - 1) / c;
  const size_t tmax = groups < tile ? groups : tile, rmax = tmax * n;
  const size_t pairs = static_cast<size_t>(k) * (k - 1) / 2;
  return 2 * static_cast<size_t>(p) + act_floats(l, static_cast<int>(rmax), hs) + rmax * (d + 4) +
         2 * tmax + 2 * static_cast<size_t>(k) * stash_pitch(ch) + 3 * pairs +
         (pairs > kSegParts ? pairs : kSegParts) + k + 8 + 4 * static_cast<size_t>(l) + 6;
}

template <int N>
__global__ void __launch_bounds__(kClusterThreads, 1) fused_svgd_kernel(Params q) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const cg::cluster_group cluster = cg::this_cluster();
  const int K = q.k, T = q.t, D = q.d, H = q.h, L = q.l, P = q.p, C = q.c, CH = q.ch;
  const int me = blockIdx.x / C, rank = blockIdx.x - me * C;  // particle, CTA of its cluster
  const int tid = threadIdx.x, nth = blockDim.x;
  const int tmax = (T + C - 1) / C, tile = min(tmax, q.tile), rmax = tile * N;
  const bool tiled = tile < tmax;  // the rows loaded a tile at a time, every step
  const int t0 = task_lo(rank, T, C), nt = task_lo(rank + 1, T, C) - t0;
  const int sl = slice_len(P, C), s_lo = min(P, rank * sl), s_hi = min(P, s_lo + sl);
  const int n_pairs = K * (K - 1) / 2;
  const bool staged = s_hi - s_lo <= CH;  // one chunk holds every particle's slice
  const bool vec = P % 4 == 0 && CH % 4 == 0;  // chunks of 16-byte rows: cp.async
  const int PT = stash_pitch(CH);

  float* xst = smem;                                // [K][PT] the particles' chunk of my slice
  float* sst = xst + static_cast<size_t>(K) * PT;   // [K][PT] their scores' chunk
  float* th = sst + static_cast<size_t>(K) * PT;    // [P] this particle, whole
  float* sc = th + P;                               // [P] this CTA's partial score
  float* act = sc + P;                              // activation slots
  float* xs = act + act_floats(L, rmax, q.hs);      // [rmax][D]
  float* ys = xs + rmax * D;                        // [rmax]
  float* ms = ys + rmax;                            // [rmax]
  float* outm = ms + rmax;                          // [rmax]
  float* outk = outm + rmax;                        // [rmax]
  float* pls = outk + rmax;                         // [tile]
  float* pnz = pls + tile;                          // [tile]
  float* pd2 = pnz + tile;                          // [pairs] my slice's squared distances
  float* d2p = pd2 + n_pairs;                       // [pairs] the cluster's sum
  int* pij = reinterpret_cast<int*>(d2p + n_pairs); // [pairs] pair (i, j) as i * 256 + j
  float* seg = d2p + 2 * n_pairs;                   // [max(pairs, kSegParts)] segments' sums
  float* kw = seg + max(n_pairs, static_cast<int>(kSegParts));  // [K] my particle's kernel row
  float* scal = kw + K;                             // [8] block-wide scalars; 4-6 the tiles' sums
  int* o = reinterpret_cast<int*>(scal + 8);        // [4L + 6] the leaf offsets
  const ClusterRows w{act, xs, ys, ms, outm, outk, pls, pnz, nullptr, scal + 4,
                      t0, nt, nt * N, rmax, q.hs};

  for (int c = tid; c < P; c += nth) th[c] = q.theta[static_cast<size_t>(me) * P + c];
  if (!tiled) load_rows(q.x, q.y, q.mask, N, D, w);
  for (int i = tid; i < 4 * L + 6; i += nth) o[i] = q.offs[i];
  for (int i = 0, pr = 0; i < K; ++i)
    for (int j = i + 1; j < K; ++j, ++pr)
      if (pr % nth == tid) pij[pr] = i * 256 + j;
  __syncthreads();

  float* m_me = q.m + static_cast<size_t>(me) * P;
  float* v_me = q.v + static_cast<size_t>(me) * P;
  for (int it = 0; it < q.n_steps; ++it) {
    const int par = it & 1;

    // ---- my tasks' partial of the particle's score; the cluster's sum of my
    // slice, the hyper-prior term; publish the slice
    cluster_score<N, false>(th, sc, o, D, H, L, q.w_t,
                         q.counts == nullptr ? nullptr : q.counts + static_cast<size_t>(it) * T,
                         w, nullptr, tile, tiled ? q.x : nullptr, q.y, q.mask);
    cluster.sync();
    float* th_pub = q.th_buf + (static_cast<size_t>(par) * K + me) * P;
    float* s_pub = q.s_buf + (static_cast<size_t>(par) * K + me) * P;
    for (int c = s_lo + tid; c < s_hi; c += nth) {
      const float scale = q.prior_scale[c];
      th_pub[c] = th[c];
      s_pub[c] = cluster_sum(cluster, sc, c) + q.pf * (-(th[c] - q.prior_loc[c]) / (scale * scale));
    }
    grid.sync();

    // ---- every pair's squared distance over my slice, staged by chunks of CH
    // coordinates (the particles' and their scores')
    const float* th_all = q.th_buf + static_cast<size_t>(par) * K * P;
    const float* s_all = q.s_buf + static_cast<size_t>(par) * K * P;
    for (int pr = tid; pr < n_pairs; pr += nth) pd2[pr] = 0.f;
    for (int base = s_lo; base < s_hi; base += CH) {
      const int len = min(CH, s_hi - base);
      if (vec) {  // asynchronous 16-byte copies: the particles', then (one chunk) the scores'
        const int len4 = len >> 2;
        for (int e = tid; e < K * len4; e += nth) {
          const int i = e / len4, v = 4 * (e - i * len4);
          cp_async16(xst + i * PT + v, th_all + static_cast<size_t>(i) * P + base + v);
        }
        cp_async_commit();
        if (staged) {
          for (int e = tid; e < K * len4; e += nth) {
            const int i = e / len4, v = 4 * (e - i * len4);
            cp_async16(sst + i * PT + v, s_all + static_cast<size_t>(i) * P + base + v);
          }
        }
        cp_async_commit();
        cp_async_wait<1>();  // the particles' copies; the scores' land during the distances
      } else {
        for (int cc = tid; cc < len; cc += nth)
          stage_rows2(th_all + base + cc, s_all + base + cc, P, K, xst + cc, sst + cc, PT);
      }
      __syncthreads();
      // segments of the chunk: about two (pair, segment) sums a thread, then
      // each pair's segments in order
      const int n_seg =
          n_pairs == 0 ? 1 : max(1, min((len + 31) / 32, static_cast<int>(kSegParts) / n_pairs));
      const int seg_len = (len + n_seg - 1) / n_seg;
      for (int e = tid; e < n_pairs * n_seg; e += nth) {
        const int sg = e / n_pairs, pr = e - sg * n_pairs;
        const float* xi = xst + (pij[pr] >> 8) * PT;
        const float* xj = xst + (pij[pr] & 255) * PT;
        float acc = 0.f;
        for (int cc = sg * seg_len; cc < min(len, (sg + 1) * seg_len); ++cc) {
          const float dv = xi[cc] - xj[cc];
          acc = fmaf(dv, dv, acc);
        }
        seg[e] = acc;
      }
      __syncthreads();
      for (int pr = tid; pr < n_pairs; pr += nth) {
        float acc = pd2[pr];
        for (int sg = 0; sg < n_seg; ++sg) acc += seg[sg * n_pairs + pr];
        pd2[pr] = acc;
      }
      __syncthreads();
    }
    cluster.sync();

    // ---- the cluster's distances (rank order), the median (rank K*K/2, exact
    // selection), my particle's kernel row; transport and Adam of my slice
    for (int pr = tid; pr < n_pairs; pr += nth) d2p[pr] = cluster_sum(cluster, pd2, pr);
    const float gamma = rbf_gamma(median_upper_pairs(d2p, n_pairs, K, scal), q.log_kp1);
    if (tid < K) {
      const float dd = tid == me ? 0.f : d2p[pair_index(min(me, tid), max(me, tid), K)];
      kw[tid] = expf(-gamma * dd);
    }
    if (vec) cp_async_wait<0>();
    __syncthreads();
    float row_sum = 0.f;
    for (int j = 0; j < K; ++j) row_sum += kw[j];

    const float t_f = q.step0 + static_cast<float>(it) + 1.f;
    const float bc1 = 1.f - expf(t_f * kLogB1);
    const float bc2 = 1.f - expf(t_f * kLogB2);
    const float two_gamma = 2.f * gamma;
    for (int c = s_lo + tid; c < s_hi; c += nth) {
      if (staged) {
        const int cc = c - s_lo;
        th[c] = transport_adam(
            kw, K, row_sum, two_gamma, th[c], [&](int j) { return sst[j * PT + cc]; },
            [&](int j) { return xst[j * PT + cc]; }, m_me[c], v_me[c], q.lr, bc1, bc2);
      } else {
        th[c] = transport_adam_l2(kw, K, row_sum, two_gamma, th[c], s_all + c, th_all + c, P,
                                  m_me[c], v_me[c], q.lr, bc1, bc2);
      }
    }
    // every CTA's slice is updated (and no CTA reads another's shared memory
    // any more, so none may exit early); then the particle whole again
    cluster.sync();
    if (it + 1 < q.n_steps) {
      cluster_gather(cluster, th, P);
      __syncthreads();
    }
  }

  for (int c = s_lo + tid; c < s_hi; c += nth) q.theta[static_cast<size_t>(me) * P + c] = th[c];
}

}  // namespace

extern "C" int pacoh_fused_svgd(float* theta, float* m, float* v, const float* x, const float* y,
                                const float* mask, const float* w_t, const float* counts,
                                const float* prior_loc, const float* prior_scale, const int* offs,
                                float* th_buf, float* s_buf, int k, int t, int n, int d, int h,
                                int l, int p, int n_steps, int c, int hs, int ch, int tile,
                                float step0, float lr, float pf, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k < 1 || k > kMaxK || n < 1 || n > kMaxN || t < 1 || d < 1 || h < 1 || l < 1 || p < 1 ||
      n_steps < 1 || c < 1 || c > kMaxCluster || (hs != h && hs != h + 1) || ch < 1 || tile < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_floats(k, t, n, d, l, p, c, hs, ch, tile) * sizeof(float);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const Params q{theta, m, v, x, y, mask, w_t, counts, prior_loc, prior_scale, offs, th_buf, s_buf,
                 k, t, n, d, h, l, p, n_steps, c, hs, ch, tile, step0, lr, pf,
                 static_cast<float>(log(static_cast<double>(k + 1)))};
  return with_task_size(n, [&](auto nn) {
    return cluster_launch(fused_svgd_kernel<decltype(nn)::value>, q, k, c, bytes,
                          static_cast<cudaStream_t>(stream));
  });
}

// Resident clusters of c CTAs of the kernel at this configuration, into *out
// (cudaOccupancyMaxActiveClusters).
extern "C" int pacoh_fused_svgd_clusters(int k, int t, int n, int d, int h, int l, int p, int c,
                                         int hs, int ch, int tile, int* out, int device,
                                         void* stream) {
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c < 1 || c > kMaxCluster || (hs != h && hs != h + 1) || ch < 1 || tile < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_floats(k, t, n, d, l, p, c, hs, ch, tile) * sizeof(float);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  return with_task_size(n, [&](auto nn) {
    return cluster_capacity(fused_svgd_kernel<decltype(nn)::value>, c, bytes, out);
  });
}
