// A whole PACOH-SVGD training run in one launch: n_steps iterations of
// (particle score, Stein transport, Adam) for K particles of a GP prior with
// an NN mean and an NN kernel (feature_dim 1, L hidden layers of width H),
// on T tasks of N <= 8 points.
//
// Replaces the Pallas TPU kernel meta_learning_pacoh_tpu/ops/pallas/
// fused_train_kernel.py (fused_svgd_train_packed; body _make_kernel with
// make_score_section, make_transport_section and the optax-exact Adam).
// Per step and particle:
//   score     the GP prior's score section (score_section.cuh, shared with
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
// particle's step is about 1.3 MFLOP of MLP products and a few thousand
// flops of 5x5 linear algebra per task, so neither HBM bytes nor the card's
// flops bound it. One SM per particle does: its instruction rate, mostly the
// shared-memory loads of the MLP products (two loads per multiply-add, 10 of
// the card's SMs busy), then the chain of block barriers, the two grid-wide
// barriers of the transport, and the serial per-task factorization (one
// thread a task). About 81 us a step at sin_20 (H100 80GB HBM3, 700 W).
// The design keeps everything on chip that the step reuses. One block owns
// one particle: its parameters, score and both nets' activations live in
// dynamic shared memory (about 72 KB at sin_20), the Adam moments in device
// memory (touched once a step). The transport is the only coupling: each
// block publishes its parameters and score to an L2-resident scratch,
// double-buffered by step parity so that no block overwrites what a slower
// block still reads, then a grid barrier (cooperative launch), each block's
// row of squared distances, a second grid barrier, and every block selects
// the same median and updates its own particle. No float atomics: every sum
// has one fixed order, so results are bit-identical however a run is split
// into launches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "score_section.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 32;
constexpr int kMaxN = 8;
constexpr size_t kMaxSmem = 232448;
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
  const int* offs;      // leaf offsets, see the kernel
  float* th_buf;        // [2, K, P] scratch
  float* s_buf;         // [2, K, P] scratch
  float* d2;            // [K, K] scratch
  int k, t, n, d, h, l, p, n_steps;
  float step0, lr, pf, log_kp1;
};

// Shared-memory floats of one block; ops/cuda/fused_svgd_kernel.py
// (smem_bytes) states the same count.
size_t smem_floats(int k, int t, int n, int d, int h, int l, int p) {
  const size_t m = static_cast<size_t>(t) * n;
  return 2 * static_cast<size_t>(p) + 2 * static_cast<size_t>(l) * m * h + m * (d + 4) +
         2 * static_cast<size_t>(t) + static_cast<size_t>(k) * k + k + 8;
}

__global__ void __launch_bounds__(kThreads) fused_svgd_kernel(Params q) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int K = q.k, T = q.t, N = q.n, D = q.d, H = q.h, L = q.l, P = q.p;
  const int M = T * N;
  const int me = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nth >> 5;

  float* th = smem;                 // [P] this particle
  float* sc = th + P;               // [P] its score
  float* act = sc + P;              // [2 nets][L][M][H] activations, then their gradients
  float* xs = act + 2 * L * M * H;  // [M][D]
  float* ys = xs + M * D;           // [M]
  float* ms = ys + M;               // [M]
  float* outm = ms + M;             // [M] mean-net output, then d(mean)
  float* outk = outm + M;           // [M] kernel-net feature, then d(feature)
  float* pls = outk + M;            // [T] per-task d(lengthscale)
  float* pnz = pls + T;             // [T] per-task d(noise)
  float* d2s = pnz + T;             // [K*K]
  float* kw = d2s + K * K;          // [K] my row of the RBF kernel
  float* scal = kw + K;             // [8] block-wide scalars
  const ScoreSmem ws{act, xs, ys, ms, outm, outk, pls, pnz, nullptr};

  // leaf offsets: per net (0 mean, 1 kernel) w_l, b_l for each layer, then
  // w_out, b_out; after both nets lengthscale_raw, noise_raw
  const int* o = q.offs;

  for (int c = tid; c < P; c += nth) th[c] = q.theta[static_cast<size_t>(me) * P + c];
  for (int c = tid; c < M * D; c += nth) xs[c] = q.x[c];
  for (int c = tid; c < M; c += nth) {
    ys[c] = q.y[c];
    ms[c] = q.mask[c];
  }
  __syncthreads();

  for (int it = 0; it < q.n_steps; ++it) {
    const int par = it & 1;

    // ---- the particle's score (score_section.cuh), without the hyper-prior term
    score_section<false>(th, sc, o, T, N, D, H, L, q.w_t,
                         q.counts == nullptr ? nullptr : q.counts + static_cast<size_t>(it) * T,
                         ws, nullptr);

    // ---- hyper-prior term; publish this particle and its score
    float* th_pub = q.th_buf + (static_cast<size_t>(par) * K + me) * P;
    float* s_pub = q.s_buf + (static_cast<size_t>(par) * K + me) * P;
    for (int c = tid; c < P; c += nth) {
      const float scale = q.prior_scale[c];
      const float s = sc[c] + q.pf * (-(th[c] - q.prior_loc[c]) / (scale * scale));
      sc[c] = s;
      th_pub[c] = th[c];
      s_pub[c] = s;
    }
    grid.sync();

    // ---- my row of pairwise squared distances, one warp a partner; the
    // same lanes and reduction in every block keep d2 exactly symmetric
    const float* th_all = q.th_buf + static_cast<size_t>(par) * K * P;
    const float* s_all = q.s_buf + static_cast<size_t>(par) * K * P;
    for (int j = warp; j < K; j += n_warps) {
      float acc = 0.f;
      for (int c = lane; c < P; c += 32) {
        const float dv = th[c] - __ldcg(th_all + static_cast<size_t>(j) * P + c);
        acc += dv * dv;
      }
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) q.d2[me * K + j] = acc;
    }
    grid.sync();

    // ---- median (rank K*K/2, exact selection), my kernel row, transport, Adam
    const int kk = K * K;
    for (int c = tid; c < kk; c += nth) d2s[c] = __ldcg(q.d2 + c);
    const float gamma = rbf_gamma(median_upper(d2s, kk, scal), q.log_kp1);
    if (tid < K) kw[tid] = expf(-gamma * d2s[me * K + tid]);
    __syncthreads();
    float row_sum = 0.f;
    for (int j = 0; j < K; ++j) row_sum += kw[j];

    const float t_f = q.step0 + static_cast<float>(it) + 1.f;
    const float bc1 = 1.f - expf(t_f * kLogB1);
    const float bc2 = 1.f - expf(t_f * kLogB2);
    const float two_gamma = 2.f * gamma;
    float* m_me = q.m + static_cast<size_t>(me) * P;
    float* v_me = q.v + static_cast<size_t>(me) * P;
    for (int c = tid; c < P; c += nth) {
      th[c] = transport_adam(
          kw, K, row_sum, two_gamma, th[c],
          [&](int j) { return __ldcg(s_all + static_cast<size_t>(j) * P + c); },
          [&](int j) { return __ldcg(th_all + static_cast<size_t>(j) * P + c); }, m_me[c],
          v_me[c], q.lr, bc1, bc2);
    }
    __syncthreads();
  }

  for (int c = tid; c < P; c += nth) q.theta[static_cast<size_t>(me) * P + c] = th[c];
}

}  // namespace

extern "C" int pacoh_fused_svgd(float* theta, float* m, float* v, const float* x, const float* y,
                                const float* mask, const float* w_t, const float* counts,
                                const float* prior_loc, const float* prior_scale, const int* offs,
                                float* th_buf, float* s_buf, float* d2, int k, int t, int n,
                                int d, int h, int l, int p, int n_steps, float step0, float lr,
                                float pf, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k < 1 || k > kMaxK || n < 1 || n > kMaxN || t < 1 || d < 1 || h < 1 || l < 1 || p < 1 ||
      n_steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_floats(k, t, n, d, h, l, p) * sizeof(float);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(fused_svgd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // every block must be resident at once for the grid barrier
  int per_sm = 0, n_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_svgd_kernel, kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm * n_sm < k) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);

  Params q{theta, m, v, x, y, mask, w_t, counts, prior_loc, prior_scale, offs, th_buf, s_buf, d2,
           k, t, n, d, h, l, p, n_steps, step0, lr, pf,
           static_cast<float>(log(static_cast<double>(k + 1)))};
  void* args[] = {&q};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_svgd_kernel), dim3(k),
                                    dim3(kThreads), args, bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
