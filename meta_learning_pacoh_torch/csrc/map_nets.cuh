// Device code shared by the two fused PACOH-MAP training kernels,
// csrc/fused_map.cu (B6, N <= 8) and csrc/fused_map_bign.cu (B9, 9 <= N <= 512):
// both tanh MLPs' forward and backward over a block's rows one output at a
// time (the scalar passes, which the kernels take for nets whose widths are
// no multiple of map_tiles.cuh's 4-unit tiles), the AdamW constants, and the
// split AdamW step that follows a grid barrier.
//
// Included inside an anonymous namespace of each kernel's source.

// Adam constants as optax forms them in float32 from Python doubles
constexpr float kB1 = 0.9f, kB2 = 0.999f, kEps = 1e-8f;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kLogB1 = static_cast<float>(-0.10536051565782628);   // log(0.9)
constexpr float kLogB2 = static_cast<float>(-0.0010005003335835335); // log(0.999)
constexpr float kLog2Pi = 1.8378770664093453f;

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float* layer_of(float* act, const int* wd, int l, int r_max) {
  int off = 0;
  for (int i = 0; i < l; ++i) off += wd[i];
  return act + r_max * off;
}

// Forward of one net over the block's R rows: activations act[l] =
// [R][H_l] at act + R_max * (H_0 + ... + H_{l-1}); the output [R][out] into
// out. o: the net's leaf offsets w_0, b_0, ..., w_{L-1}, b_{L-1}, w_out, b_out.
__device__ void net_forward(const float* th, const int* o, const int* wd, int L, int n_out,
                            const float* xs, int D, int R, int r_max, float* act, float* out) {
  const int tid = threadIdx.x, nth = blockDim.x;
  float* prev = nullptr;
  int hp = D;
  for (int l = 0; l < L; ++l) {
    const int h = wd[l];
    const float* w = th + o[2 * l];
    const float* b = th + o[2 * l + 1];
    const float* in = l == 0 ? xs : prev;
    for (int e = tid; e < R * h; e += nth) {
      const int row = e / h, j = e % h;
      float s = b[j];
      for (int c = 0; c < hp; ++c) s += in[row * hp + c] * w[c * h + j];
      act[e] = tanhf(s);
    }
    __syncthreads();
    prev = act;
    act += r_max * h;
    hp = h;
  }
  const float* w = th + o[2 * L];
  const float* b = th + o[2 * L + 1];
  for (int e = tid; e < R * n_out; e += nth) {
    const int row = e / n_out, k = e % n_out;
    float s = 0.f;
    for (int j = 0; j < hp; ++j) s += prev[row * hp + j] * w[j * n_out + k];
    out[e] = s + b[k];
  }
}

// Backward of one net: dout [R][out] = d(sum ll)/d(output); writes minus the
// block's partial gradient of every leaf of the net into gb. The
// activations are overwritten by their gradients.
__device__ void net_backward(const float* th, const int* o, const int* wd, int L, int n_out,
                             const float* xs, int D, int R, int r_max, float* act,
                             const float* dout, float* gb) {
  const int tid = threadIdx.x, nth = blockDim.x;
  // output layer
  {
    const int h = wd[L - 1];
    float* last = layer_of(act, wd, L - 1, r_max);
    const int off_w = o[2 * L], off_b = o[2 * L + 1];
    for (int e = tid; e < (h + 1) * n_out; e += nth) {
      float s = 0.f;
      if (e < h * n_out) {
        const int j = e / n_out, k = e % n_out;
        for (int row = 0; row < R; ++row) s += last[row * h + j] * dout[row * n_out + k];
        gb[off_w + e] = -s;
      } else {
        const int k = e - h * n_out;
        for (int row = 0; row < R; ++row) s += dout[row * n_out + k];
        gb[off_b + k] = -s;
      }
    }
    __syncthreads();
    const float* w = th + off_w;
    for (int e = tid; e < R * h; e += nth) {
      const int row = e / h, j = e % h;
      float s = 0.f;
      for (int k = 0; k < n_out; ++k) s += dout[row * n_out + k] * w[j * n_out + k];
      const float av = last[e];
      last[e] = s * (1.f - av * av);
    }
    __syncthreads();
  }
  // hidden layers L-1 .. 1: cur holds dz_l, prev receives dz_{l-1}
  for (int l = L - 1; l >= 1; --l) {
    const int h = wd[l], hp = wd[l - 1];
    const int off_w = o[2 * l], off_b = o[2 * l + 1];
    float* prev = layer_of(act, wd, l - 1, r_max);
    const float* cur = layer_of(act, wd, l, r_max);
    for (int e = tid; e < hp * h + h; e += nth) {
      float s = 0.f;
      if (e < hp * h) {
        const int ci = e / h, j = e % h;
        for (int row = 0; row < R; ++row) s += prev[row * hp + ci] * cur[row * h + j];
        gb[off_w + e] = -s;
      } else {
        const int j = e - hp * h;
        for (int row = 0; row < R; ++row) s += cur[row * h + j];
        gb[off_b + j] = -s;
      }
    }
    __syncthreads();
    const float* w = th + off_w;
    for (int e = tid; e < R * hp; e += nth) {
      const int row = e / hp, ci = e % hp;
      float s = 0.f;
      for (int j = 0; j < h; ++j) s += cur[row * h + j] * w[ci * h + j];
      const float av = prev[e];
      prev[e] = s * (1.f - av * av);
    }
    __syncthreads();
  }
  // first layer
  const int h = wd[0];
  const int off_w = o[0], off_b = o[1];
  const float* dz = act;
  for (int e = tid; e < D * h + h; e += nth) {
    float s = 0.f;
    if (e < D * h) {
      const int c = e / h, j = e % h;
      for (int row = 0; row < R; ++row) s += xs[row * D + c] * dz[row * h + j];
      gb[off_w + e] = -s;
    } else {
      const int j = e - D * h;
      for (int row = 0; row < R; ++row) s += dz[row * h + j];
      gb[off_b + j] = -s;
    }
  }
}

// The split AdamW step, after the grid barrier that follows every block's
// partials: each block of the grid reduces its share of the P coordinates
// over the G partial gradients in gbuf [G, P + 1], in one fixed order, and
// applies optax's AdamW at step t_f (1-based, float32) to theta, m, v; th is
// the block's copy of the parameters the step started from. Returns the
// step's loss, the sum of the G partial losses (column P), in thread 0 of
// block 0.
__device__ __forceinline__ float adamw_split(const float* gbuf, int G, int P, const float* th,
                                             float* theta, float* m, float* v, float t_f,
                                             float lr, float wd) {
  const int tid = threadIdx.x, nth = blockDim.x, blk = blockIdx.x;
  const float bc1 = 1.f - expf(t_f * kLogB1);
  const float bc2 = 1.f - expf(t_f * kLogB2);
  for (int c = blk * nth + tid; c < P; c += gridDim.x * nth) {
    float g = 0.f;
    for (int k = 0; k < G; ++k) g += __ldcg(gbuf + static_cast<size_t>(k) * (P + 1) + c);
    const float mn = kB1 * m[c] + kOneMinusB1 * g;
    const float vn = kB2 * v[c] + kOneMinusB2 * g * g;
    m[c] = mn;
    v[c] = vn;
    const float upd = (mn / bc1) / (sqrtf(vn / bc2) + kEps);
    theta[c] = th[c] - lr * (upd + wd * th[c]);
  }
  float loss = 0.f;
  if (blk == 0 && tid == 0)
    for (int k = 0; k < G; ++k) loss += __ldcg(gbuf + static_cast<size_t>(k) * (P + 1) + P);
  return loss;
}
