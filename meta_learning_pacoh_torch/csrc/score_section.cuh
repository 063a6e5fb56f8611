// The MLP passes of PACOH's GP-prior score over one block: the fused MLAP
// kernel (fused_mlap.cu) takes nets_forward, nets_backward and factor<N>,
// with its own per-task algebra (the inner KL's) between them. The fused
// SVGD and VI kernels (fused_svgd.cu, fused_vi.cu) split the score over a
// thread-block cluster instead (cluster_score.cuh, which takes softplus and
// sigmoid from here). The counterpart of make_score_section in
// meta_learning_pacoh_tpu/ops/pallas/fused_train_kernel.py.
//
// One block runs, for one parameter vector th [P] in shared memory with an
// NN mean and an NN kernel (feature_dim 1, L hidden layers of width H), over
// M rows: both tanh MLPs forward (nets_forward) and, from d(mean) and
// d(feature), both MLPs' backward into the score (nets_backward). Every sum
// has one fixed order, so the result does not depend on which block
// computes it.

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

}  // namespace
