// The particle score of PACOH's GP prior on one task of 9 <= N <= 256
// points, one (particle or sample, task) system at a time: the section the
// big-N fused SVGD kernel (fused_svgd_bign.cu, B10, K particles) and the
// big-N fused VI kernel (fused_vi_bign.cu, B11, S samples) share. The
// counterpart of make_bign_score_section in meta_learning_pacoh_tpu/ops/
// pallas/fused_svgd_bign_kernel.py (:155-319), for one system g = k*T + t of
// its G = K*T.
//
// For parameters th [P] in shared memory, with an NN mean and an NN kernel
// (feature_dim 1, L hidden layers of width H each), on one task's rows:
//   forward   both tanh MLPs over the task's N rows (map_nets.cuh);
//             z = feature / softplus(lengthscale)
//   MLL       Kn = exp(-0.5 (z_a - z_b)^2) m_a m_b + diag(real ? softplus(noise)
//             + 1e-6 : 1), factored at the first jitter of (0, 1e-4, 1e-2)
//             that succeeds, the jitter on the real rows' diagonal only (the
//             TPU section's eye * mask, :234, :246-252; blocked_factor.cuh);
//             z = L^-1 r, W = L^-1 in place, alpha = W^T z; with the value,
//             quad + logdet = |z|^2 + 2 sum log diag L
//   backward  score_K = 0.5 w (alpha alpha^T - K^-1), each K^-1 entry formed
//             from W where used; d(mean) = w alpha m, d(z_a) = 4 sum_b dd2_ab
//             (z_a - z_b) with dd2 = -0.5 score_K m m Km where d2 > 0 (no
//             gradient where d2 = 0, :265), d(lengthscale), d(noise); both
//             MLPs' backward
// into minus the system's partial gradient of w MLL, a row [P] of device
// memory. The hyper-prior term is the caller's. The TPU section's bordered
// system (:239-249) is not carried over: the forward substitution of
// blocked_factor.cuh is cheap here. Every sum has one fixed order.
//
// Included inside an anonymous namespace of each kernel's source, after
// blocked_factor.cuh and map_nets.cuh.

// The work areas of one system: shared memory, except the activations and,
// where it does not fit shared memory, the matrix.
struct BignWork {
  float* xs;     // [N][D] the task's inputs
  float* ys;     // [N] its targets
  float* ms;     // [N] its mask
  float* outm;   // [N] mean-net output, then d(mean)
  float* outk;   // [N] kernel-net feature, then d(feature)
  float* rv;     // [N] residual
  float* zv;     // [N] L^-1 r
  float* al;     // [N] K^-1 r
  float* rowp;   // [N][3] per-row partials: d(z), d(z) (-z), d(noise)
  float* pcol;   // [kPanel][N] panel columns
  float* red;    // [1]
  float* hyp;    // [3] d(softplus lengthscale), d(noise), quad + logdet
  float* mat;    // the N x N matrix, leading dimension ld
  int ld;
  float* act_m;  // [L][N][H] mean-net activations (device scratch)
  float* act_k;  // [L][N][H] kernel-net activations (device scratch)
};

// One task's MLL gradient at weight w, by the whole block. On entry mu holds
// the task's mean-net outputs [N] and ph its features [N]; on exit mu holds
// d(w ll)/d(mean) and ph d(w ll)/d(feature); hyp [3] receives d/d(softplus
// lengthscale), d/d(noise) and quad + logdet of the factor used. A task of
// weight 0 (not drawn this step, or empty) adds exactly 0. Ends with a block
// barrier.
__device__ __noinline__ void bign_task_grad(float* mu, float* ph, const float* y,
                                            const float* msk, int N, float sp_ls, float diag_add,
                                            float w, const BignWork& k) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nth >> 5;
  float* mat = k.mat;
  const int ld = k.ld;
  if (w == 0.f) {
    for (int i = tid; i < N; i += nth) {
      mu[i] = 0.f;
      ph[i] = 0.f;
    }
    if (tid < 3) k.hyp[tid] = 0.f;
    __syncthreads();
    return;
  }
  // features -> z = feature / lengthscale, in place; the masked residual
  for (int i = tid; i < N; i += nth) {
    ph[i] /= sp_ls;
    k.rv[i] = (y[i] - mu[i]) * msk[i];
  }
  __syncthreads();

  const int level = factor_escalated(mat, N, ld, k.pcol, [&](float* a, float jit) {
    for (int idx = tid; idx < N * N; idx += nth) {
      const int i = idx / N, c = idx % N;
      if (c > i) continue;
      const float dz = ph[i] - ph[c];
      float v = expf(-0.5f * (dz * dz)) * msk[i] * msk[c];
      if (i == c) {
        if (msk[i] > 0.f) {
          v += diag_add;
          v += jit;
        } else {
          v += 1.f;
        }
      }
      a[i * ld + c] = v;
    }
  });
  if (level < 0) {  // no level factors: NaN, as the TPU section's last level gives
    for (int idx = tid; idx < N * N; idx += nth) {
      const int i = idx / N, c = idx % N;
      if (c <= i) mat[i * ld + c] = nanf("");
    }
    __syncthreads();
  }
  const float quad = forward_subst(mat, N, ld, k.rv, k.zv, k.red);
  const float ql = quad + logdet_lower(mat, N, ld, k.red);
  invert_lower(mat, N, ld, k.pcol);
  wt_times(mat, N, ld, k.zv, k.al);
  const float* al = k.al;
  for (int i = tid; i < N; i += nth) mu[i] = w * al[i] * msk[i];

  // a warp per row a, lanes along the columns b: score_ab and its chains
  for (int a = warp; a < N; a += n_warps) {
    const float ma = msk[a], al_a = al[a], za = ph[a];
    float dz = 0.f, dn = 0.f;
    for (int b = lane; b < N; b += 32) {
      const float s = 0.5f * w * (al_a * al[b] - kinv_entry(mat, N, ld, a, b));
      const float dkm = s * ma * msk[b];
      if (b == a) dn += s * ma;
      const float diff = za - ph[b];
      const float d2 = diff * diff;
      const float dd2 = d2 > 0.f ? -0.5f * dkm * expf(-0.5f * d2) : 0.f;
      dz += 4.f * dd2 * diff;
    }
    dz = warp_sum(dz);
    dn = warp_sum(dn);
    if (lane == 0) {
      float* rp = k.rowp + 3 * a;
      rp[0] = dz;
      rp[1] = dz * (-za);
      rp[2] = dn;
    }
  }
  __syncthreads();
  for (int i = tid; i < N; i += nth) ph[i] = k.rowp[3 * i] / sp_ls;
  if (tid < 2) {  // the task's sums over its rows, in order
    float s = 0.f;
    for (int a = 0; a < N; ++a) s += k.rowp[3 * a + 1 + tid];
    k.hyp[tid] = tid == 0 ? s / sp_ls : s;
  }
  if (tid == 2) k.hyp[2] = ql;
  __syncthreads();
}

// One system: th [P] the parameters (shared), the task's rows in k.xs, k.ys,
// k.ms; o the leaf offsets (per net, mean then kernel, w_l, b_l of every
// hidden layer, then w_out, b_out; then lengthscale_raw, noise_raw), wd
// [2L] the hidden widths (the mean net's, then the kernel net's). Writes
// minus the system's partial gradient of w MLL into gb [P] and returns, to
// every thread, the task's quad + logdet (0 for w = 0). Ends with a block
// barrier.
__device__ float bign_system(const float* th, const int* o, const int* wd, int L, int N, int D,
                             float w, float* gb, const BignWork& k) {
  const int tid = threadIdx.x;
  const int* o_m = o;
  const int* o_k = o + 2 * L + 2;
  const int off_ls = o[4 * L + 4], off_nz = o[4 * L + 5];
  net_forward(th, o_m, wd, L, 1, k.xs, D, N, N, k.act_m, k.outm);
  net_forward(th, o_k, wd + L, L, 1, k.xs, D, N, N, k.act_k, k.outk);
  __syncthreads();
  const float sp_ls = softplus(th[off_ls]);
  bign_task_grad(k.outm, k.outk, k.ys, k.ms, N, sp_ls, softplus(th[off_nz]) + 1e-6f, w, k);
  net_backward(th, o_m, wd, L, 1, k.xs, D, N, N, k.act_m, k.outm, gb);
  net_backward(th, o_k, wd + L, L, 1, k.xs, D, N, N, k.act_k, k.outk, gb);
  if (tid == 0) {
    gb[off_ls] = -(k.hyp[0] * sigmoid(th[off_ls]));
    gb[off_nz] = -(k.hyp[1] * sigmoid(th[off_nz]));
  }
  const float ql = k.hyp[2];
  __syncthreads();
  return ql;
}
