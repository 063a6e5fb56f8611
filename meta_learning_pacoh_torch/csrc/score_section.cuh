// The particle score of PACOH's GP prior, shared by the fused SVGD kernel
// (fused_svgd.cu, one block per particle) and the fused VI kernel
// (fused_vi.cu, one block per posterior sample); the counterpart of
// make_score_section in meta_learning_pacoh_tpu/ops/pallas/
// fused_train_kernel.py. The fused MLAP kernel (fused_mlap.cu) takes its
// two MLP passes, nets_forward and nets_backward, and factor<N>, with its
// own per-task algebra (the inner KL's) between them.
//
// One block computes, for one parameter vector th [P] in shared memory with
// an NN mean and an NN kernel (feature_dim 1, L hidden layers of width H),
// on T tasks of N <= 8 points:
//   forward   both tanh MLPs over the T*N rows; softplus lengthscale, noise
//   MLL       per task (one thread a task), the entry-wise Kn (noise + 1e-6
//             on real diagonals, 1.0 on padded ones), trial factorizations
//             at jitter 0 and 1e-4 choosing 0 / 1e-4 / 1e-2 (a factor is
//             good when every diagonal is finite and > 0), L, alpha, L^-1,
//             K^-1, and, when asked, the value quad + logdet
//   backward  G = 0.5 w (alpha alpha^T - K^-1) into d(mean), d(feature),
//             d(lengthscale), d(noise); both MLPs' backward
// into sc [P]: the gradient of sum_t w_t MLL_t without the hyper-prior term,
// which each caller adds in its own pass over P. Every sum has one fixed
// order, so the result does not depend on which block computes it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

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

// One task's masked MLL gradient. mu/ph are the rows' net outputs on entry
// and receive d(mean)/d(feature) on exit (every read happens first). With
// kValue, *ql_out receives the task's quad + logdet of the factor used.
template <int N, bool kValue>
__device__ void task_grad(float* mu, float* ph, const float* y, const float* msk, float sp_ls,
                          float sp_nz, float w, float* dls_out, float* dnz_out, float* ql_out) {
  float z[N], mk[N], r[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    z[i] = ph[i] / sp_ls;
    mk[i] = msk[i];
    r[i] = (y[i] - mu[i]) * mk[i];
  }
  float a[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const float dz = z[i] - z[j];
      float val = expf(-0.5f * dz * dz) * mk[i] * mk[j];
      if (i == j) val += mk[i] > 0.f ? sp_nz + 1e-6f : 1.f;
      a[i][j] = val;
    }
  }
  float lf[N][N];
  if (!factor<N>(a, 0.f, lf) && !factor<N>(a, 1e-4f, lf)) factor<N>(a, 1e-2f, lf);

  float zs[N], al[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = r[i];
#pragma unroll
    for (int q = 0; q < i; ++q) s -= lf[i][q] * zs[q];
    zs[i] = s / lf[i][i];
  }
  if (kValue) {
    float ql = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) ql += zs[i] * zs[i] + 2.f * logf(lf[i][i]);
    *ql_out = ql;
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

  float dn = 0.f, dl = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mu[i] = w * al[i] * mk[i];
    dn += 0.5f * w * (al[i] * al[i] - a[i][i]) * mk[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float g = 0.5f * w * (al[i] * al[j] - a[i][j]);
      const float dz = z[i] - z[j];
      const float dd2 = -0.5f * (g * mk[i] * mk[j]) * expf(-0.5f * dz * dz);
      acc += 2.f * dd2 * dz;
    }
    const float dz_i = 2.f * acc;
    ph[i] = dz_i / sp_ls;
    dl += dz_i * (-z[i]) / sp_ls;
  }
  *dls_out = dl;
  *dnz_out = dn;
}

template <bool kValue>
__device__ void task_grad_n(int n, float* mu, float* ph, const float* y, const float* msk,
                            float sp_ls, float sp_nz, float w, float* dl, float* dn, float* ql) {
  switch (n) {
    case 1: task_grad<1, kValue>(mu, ph, y, msk, sp_ls, sp_nz, w, dl, dn, ql); break;
    case 2: task_grad<2, kValue>(mu, ph, y, msk, sp_ls, sp_nz, w, dl, dn, ql); break;
    case 3: task_grad<3, kValue>(mu, ph, y, msk, sp_ls, sp_nz, w, dl, dn, ql); break;
    case 4: task_grad<4, kValue>(mu, ph, y, msk, sp_ls, sp_nz, w, dl, dn, ql); break;
    case 5: task_grad<5, kValue>(mu, ph, y, msk, sp_ls, sp_nz, w, dl, dn, ql); break;
    case 6: task_grad<6, kValue>(mu, ph, y, msk, sp_ls, sp_nz, w, dl, dn, ql); break;
    case 7: task_grad<7, kValue>(mu, ph, y, msk, sp_ls, sp_nz, w, dl, dn, ql); break;
    default: task_grad<8, kValue>(mu, ph, y, msk, sp_ls, sp_nz, w, dl, dn, ql); break;
  }
}

// The block's shared-memory work areas of the score section.
struct ScoreSmem {
  float* act;   // [2 nets][L][M][H] activations, then their gradients
  float* xs;    // [M][D]
  float* ys;    // [M]
  float* ms;    // [M]
  float* outm;  // [M] mean-net output, then d(mean)
  float* outk;  // [M] kernel-net feature, then d(feature)
  float* pls;   // [T] per-task d(lengthscale)
  float* pnz;   // [T] per-task d(noise)
  float* pql;   // [T] per-task w_t (quad + logdet), with kValue
};

// The forward of both nets of th [P] over the M rows of w.xs: activations
// into w.act, the mean net's output into w.outm, the kernel net's feature
// into w.outk. o: the leaf offsets, per net (0 mean, 1 kernel) w_l, b_l for
// each layer, then w_out, b_out; after both nets lengthscale_raw,
// noise_raw. Ends with a block barrier.
__device__ __forceinline__ void nets_forward(const float* th, const int* o, int M, int D, int H,
                                             int L, const ScoreSmem& w) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int S = 2 * L + 2;
  float* act = w.act;
  const float* xs = w.xs;
  float* outm = w.outm;
  float* outk = w.outk;
  for (int net = 0; net < 2; ++net) {
    float* a_net = act + net * L * M * H;
    const float* w0 = th + o[net * S];
    const float* b0 = th + o[net * S + 1];
    for (int e = tid; e < M * H; e += nth) {
      const int row = e / H, j = e % H;
      float s = b0[j];
      for (int c = 0; c < D; ++c) s += xs[row * D + c] * w0[c * H + j];
      a_net[e] = tanhf(s);
    }
    __syncthreads();
    for (int l = 1; l < L; ++l) {
      const float* wl = th + o[net * S + 2 * l];
      const float* bl = th + o[net * S + 2 * l + 1];
      const float* prev = a_net + (l - 1) * M * H;
      float* cur = a_net + l * M * H;
      for (int e = tid; e < M * H; e += nth) {
        const int row = e / H, j = e % H;
        float s = 0.f;
        for (int c = 0; c < H; ++c) s += prev[row * H + c] * wl[c * H + j];
        cur[e] = tanhf(s + bl[j]);
      }
      __syncthreads();
    }
    const float* last = a_net + (L - 1) * M * H;
    const float* wout = th + o[net * S + 2 * L];
    const float bout = th[o[net * S + 2 * L + 1]];
    float* out = net == 0 ? outm : outk;
    for (int row = tid; row < M; row += nth) {
      float s = 0.f;
      for (int j = 0; j < H; ++j) s += last[row * H + j] * wout[j];
      out[row] = s + bout;
    }
  }
  __syncthreads();
}

// The backward of both nets of th [P] into sc [P] (every weight and bias of
// both nets), from d(mean) in w.outm and d(feature) in w.outk; w.act holds
// the forward's activations and receives their gradients. No trailing
// barrier.
__device__ __forceinline__ void nets_backward(const float* th, float* sc, const int* o, int M,
                                              int D, int H, int L, const ScoreSmem& w) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int S = 2 * L + 2;
  float* act = w.act;
  const float* xs = w.xs;
  const float* outm = w.outm;
  const float* outk = w.outk;
  for (int net = 0; net < 2; ++net) {
    float* a_net = act + net * L * M * H;
    const float* dout = net == 0 ? outm : outk;
    float* last = a_net + (L - 1) * M * H;
    const int off_wout = o[net * S + 2 * L], off_bout = o[net * S + 2 * L + 1];
    const float* wout = th + off_wout;
    for (int j = tid; j <= H; j += nth) {
      float s = 0.f;
      if (j < H) {
        for (int row = 0; row < M; ++row) s += last[row * H + j] * dout[row];
        sc[off_wout + j] = s;
      } else {
        for (int row = 0; row < M; ++row) s += dout[row];
        sc[off_bout] = s;
      }
    }
    __syncthreads();
    for (int e = tid; e < M * H; e += nth) {
      const float av = last[e];
      last[e] = dout[e / H] * wout[e % H] * (1.f - av * av);
    }
    __syncthreads();
    for (int l = L - 1; l >= 1; --l) {
      const int off_w = o[net * S + 2 * l], off_b = o[net * S + 2 * l + 1];
      const float* wl = th + off_w;
      float* prev = a_net + (l - 1) * M * H;
      const float* cur = a_net + l * M * H;
      for (int e = tid; e < H * H + H; e += nth) {
        float s = 0.f;
        if (e < H * H) {
          const int ci = e / H, j = e % H;
          for (int row = 0; row < M; ++row) s += prev[row * H + ci] * cur[row * H + j];
          sc[off_w + e] = s;
        } else {
          const int j = e - H * H;
          for (int row = 0; row < M; ++row) s += cur[row * H + j];
          sc[off_b + j] = s;
        }
      }
      __syncthreads();
      for (int e = tid; e < M * H; e += nth) {
        const int row = e / H, ci = e % H;
        float s = 0.f;
        // rotated start: the threads of a warp read different banks
        // (j = (c + ci) mod H, kept without an integer division)
        int j = ci;
        for (int c = 0; c < H; ++c) {
          s += cur[row * H + j] * wl[ci * H + j];
          j = j + 1 == H ? 0 : j + 1;
        }
        const float av = prev[e];
        prev[e] = s * (1.f - av * av);
      }
      __syncthreads();
    }
    const int off_w0 = o[net * S], off_b0 = o[net * S + 1];
    for (int e = tid; e < D * H + H; e += nth) {
      float s = 0.f;
      if (e < D * H) {
        const int c = e / H, j = e % H;
        for (int row = 0; row < M; ++row) s += xs[row * D + c] * a_net[row * H + j];
        sc[off_w0 + e] = s;
      } else {
        const int j = e - D * H;
        for (int row = 0; row < M; ++row) s += a_net[row * H + j];
        sc[off_b0 + j] = s;
      }
    }
  }
}

// The score section of th [P] into sc [P] (see the top of this file). o: the
// leaf offsets (nets_forward). w_t [T] the task weights, counts [T] this
// step's draw counts or null. With kValue, *wql_out receives sum_t w_t
// (quad_t + logdet_t) (an undrawn or empty task adds exactly 0). Ends with a
// block barrier.
template <bool kValue>
__device__ __forceinline__ void score_section(const float* th, float* sc, const int* o, int T,
                                              int N, int D, int H, int L, const float* w_t,
                                              const float* counts, const ScoreSmem& w,
                                              float* wql_out) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int M = T * N;
  const int S = 2 * L + 2;
  const int off_ls = o[2 * S], off_nz = o[2 * S + 1];
  float* outm = w.outm;
  float* outk = w.outk;

  nets_forward(th, o, M, D, H, L, w);

  // ---- per-task MLL gradient, one thread a task
  const float ls_raw = th[off_ls], nz_raw = th[off_nz];
  const float sp_ls = softplus(ls_raw), sp_nz = softplus(nz_raw);
  for (int t = tid; t < T; t += nth) {
    float wt = w_t[t];
    if (counts != nullptr) {
      const float c = counts[t];
      wt = c > 0.f ? wt * c : 0.f;
    }
    float ql = 0.f;
    task_grad_n<kValue>(N, outm + t * N, outk + t * N, w.ys + t * N, w.ms + t * N, sp_ls, sp_nz,
                        wt, w.pls + t, w.pnz + t, &ql);
    if (kValue) w.pql[t] = wt > 0.f ? wt * ql : 0.f;
  }
  __syncthreads();

  // ---- backward of both nets into the score
  nets_backward(th, sc, o, M, D, H, L, w);
  if (tid == 0) {
    float sl = 0.f, sn = 0.f, sq = 0.f;
    for (int t = 0; t < T; ++t) {
      sl += w.pls[t];
      sn += w.pnz[t];
      if (kValue) sq += w.pql[t];
    }
    sc[off_ls] = sl * sigmoid(ls_raw);
    sc[off_nz] = sn * sigmoid(nz_raw);
    if (kValue) *wql_out = sq;
  }
  __syncthreads();
}

}  // namespace
