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
//   MLL       the bordered system of the TPU section (:239-249): Kn =
//             exp(-0.5 (z_a - z_b)^2) m_a m_b + diag(real ? softplus(noise)
//             + 1e-6 : 1) with the residual r as its row N, factored in
//             32-column panels (tiled_chol.cuh) at the first jitter of (0,
//             1e-4, 1e-2) that succeeds, the jitter on the real rows'
//             diagonal only (the TPU's eye * mask, :234, :246-252); the
//             border row comes out as z = L^-1 r, so quad + logdet = |z|^2 +
//             2 sum log diag L needs no forward substitution; W = L^-1 and
//             K^-1 = W^T W in place (tiled_inverse.cuh), alpha = W^T z
//   backward  score_K = 0.5 w (alpha alpha^T - K^-1), each K^-1 entry read
//             once; d(mean) = w alpha m, d(z_a) = 4 sum_b dd2_ab (z_a - z_b)
//             with dd2 = -0.5 score_K m m Km where d2 > 0 (no gradient where
//             d2 = 0, :265), d(lengthscale), d(noise); both MLPs' backward
// into minus the system's partial gradient of w MLL, a row [P] of device
// memory. The hyper-prior term is the caller's. Every sum has one fixed
// order.
//
// Included inside an anonymous namespace of each kernel's source, after
// tiled_chol.cuh, tiled_inverse.cuh and map_nets.cuh.

// Shared-memory floats of a system's small work areas beside the parameters:
// the task's rows [N][D] and the per-point vectors (ys, ms, outm, outk, rv,
// al, rowp [N][3], the border row when the matrix is in device memory) and
// hyp, the tile logs and quad. ops/cuda/fused_svgd_bign_kernel.py
// (smem_bytes) states the same.
__host__ __device__ __forceinline__ size_t bign_vector_floats(int n, int d) {
  return static_cast<size_t>(n) * (d + 10) + 4 + kMaxTiles + 4;
}

// Shared-memory floats of the tiled matrix's area: its scratch and, when
// held there, the packed triangle with the border row.
__host__ __device__ __forceinline__ size_t bign_matrix_floats(int n, int shared) {
  return shared ? tiled_packed_floats(n, n + 1) : tiled_scratch_floats(n, n + 1);
}

// Floats of both nets' activations [2][L][H][N | 1] (bign_net_forward), in
// shared memory when they are held there (shared == 2;
// ops/cuda/fused_svgd_bign_kernel.py, act_bytes).
__host__ __device__ __forceinline__ size_t bign_act_size(int n, int h, int l) {
  return 2 * static_cast<size_t>(l) * (n | 1) * h;
}
__host__ __device__ __forceinline__ size_t bign_act_floats(int n, int h, int l, int shared) {
  return shared == 2 ? bign_act_size(n, h, l) : 0;
}

// The work areas of one system: shared memory, except, where they do not
// fit there, the activations and the matrix.
struct BignWork {
  float* xs;     // [N][D] the task's inputs
  float* ys;     // [N] its targets
  float* ms;     // [N] its mask
  float* outm;   // [N] mean-net output, then d(mean)
  float* outk;   // [N] kernel-net feature, then d(feature)
  float* rv;     // [N] residual
  float* al;     // [N] K^-1 r
  float* rowp;   // [N][3] per-row partials: d(z), d(z) (-z), d(noise)
  float* hyp;    // [3] d(softplus lengthscale), d(noise), quad + logdet
  float* sums;   // [kMaxTiles + 1] the diagonal tiles' sum log L_cc, then |z|^2
  float* tws;    // tiled_scratch_floats(N, N + 1): L11^T, flag, panel buffer
  TiledMatrix M;  // N rows and the border row: packed in shared memory, or the
                  // square (ld = N) in device memory with the border in [N]
  float* act_m;  // [L][H][N | 1] mean-net activations
  float* act_k;  // [L][H][N | 1] kernel-net activations
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
  const TiledMatrix M = k.M;  // its fields in registers
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
        row[c] = v;
      }
    }
    __syncthreads();
    ok = tiled_factor(M, 0.f, k.tws);
  }
  if (!ok) {  // no level factors: NaN, as the TPU section's last level gives
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
    if (lane == 0) k.sums[kMaxTiles] = q;
  }
  tiled_lauum(M);
  float ql = k.sums[kMaxTiles];
  for (int t = 0; t * kTile < N; ++t) ql += 2.f * k.sums[t];
  const float* al = k.al;
  for (int i = tid; i < N; i += nth) mu[i] = w * al[i] * msk[i];

  // a warp per row a, lanes along the columns b: score_ab and its chains,
  // (K^-1)_ab from the lower triangle, row a for b <= a, row b for b > a
  for (int a = warp; a < N; a += n_warps) {
    const float ma = msk[a], al_a = al[a], za = ph[a];
    const float* row_a = M.row(a);
    float dz = 0.f, dn = 0.f;
    for (int b = lane; b < N; b += 32) {
      const float kinv = b <= a ? row_a[b] : M.row(b)[a];
      const float s = 0.5f * w * (al_a * al[b] - kinv);
      const float dkm = s * ma * msk[b];
      if (b == a) dn += s * ma;
      const float diff = za - ph[b];
      const float d2 = diff * diff;
      const float dd2 = d2 > 0.f ? -0.5f * dkm * expf(-0.5f * d2) : 0.f;
      dz += 4.f * dd2 * diff;
    }
    dz = warp_total(dz);
    dn = warp_total(dn);
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

// Both MLPs' passes over one system's R rows, B10 and B11's own: L hidden
// tanh layers of width H, one output. The activations of layer l are held
// transposed, act + l H (R | 1) as [H][R | 1], so that the threads of a
// warp, walking the rows, read consecutive words, and units 4 apart lie in
// different banks (an odd row pitch); every product runs in 4 x 4 register
// tiles (forward, the backward's deltas) or, for the weight gradients (sums
// over the R rows), in 2 x 4 tiles whose rows a group of g lanes shares
// (group_lanes, group_total), each sum in one fixed order.

// Layer l's activations act + l H R [H][R] = tanh(b + in W) over the R rows,
// in tiles of TR rows x 4 units (in: xs [R][D] for l = 0, else layer l - 1).
template <int TR>
__device__ void bign_layer_forward(const float* th, const int* o, int l, int H, int D,
                                   const float* xs, int R, float* act) {
  const int hp = l == 0 ? D : H;
  const float* w = th + o[2 * l];
  const float* b = th + o[2 * l + 1];
  const float* prev = l > 0 ? act + static_cast<size_t>(l - 1) * H * (R | 1) : xs;
  float* cur = act + static_cast<size_t>(l) * H * (R | 1);
  const int ld = R | 1, tr = (R + TR - 1) / TR, tj = (H + 3) / 4;
  for (int t = threadIdx.x; t < tr * tj; t += blockDim.x) {  // a warp's row tiles side by side
    const int r0 = TR * (t % tr), j0 = 4 * (t / tr);
    float acc[TR][4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float bv = j0 + v < H ? b[j0 + v] : 0.f;
#pragma unroll
      for (int u = 0; u < TR; ++u) acc[u][v] = bv;
    }
    for (int c = 0; c < hp; ++c) {
      float a[TR], wv[4];
#pragma unroll
      for (int u = 0; u < TR; ++u)
        a[u] = r0 + u < R ? (l == 0 ? xs[(r0 + u) * D + c] : prev[c * ld + r0 + u]) : 0.f;
#pragma unroll
      for (int v = 0; v < 4; ++v) wv[v] = j0 + v < H ? w[c * H + j0 + v] : 0.f;
#pragma unroll
      for (int u = 0; u < TR; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], wv[v], acc[u][v]);
    }
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int u = 0; u < TR; ++u)
        if (r0 + u < R && j0 + v < H) cur[(j0 + v) * ld + r0 + u] = tanhf(acc[u][v]);
  }
}

// out [R] = the net at th (leaf offsets o: w_0, b_0, ..., w_out, b_out) over
// xs [R][D]; no barrier at its end. Row tiles of 4 where there are rows
// enough to fill the block with them, else of 1.
__device__ void bign_net_forward(const float* th, const int* o, int L, int H, int D,
                                 const float* xs, int R, float* act, float* out) {
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int l = 0; l < L; ++l) {
    if (R >= 64)
      bign_layer_forward<4>(th, o, l, H, D, xs, R, act);
    else
      bign_layer_forward<1>(th, o, l, H, D, xs, R, act);
    __syncthreads();
  }
  const float* last = act + static_cast<size_t>(L - 1) * H * (R | 1);
  const float* w = th + o[2 * L];
  const float b = th[o[2 * L + 1]];
  for (int r = tid; r < R; r += nth) {
    float s = 0.f;
    for (int j = 0; j < H; ++j) s = fmaf(last[j * (R | 1) + r], w[j], s);
    out[r] = s + b;
  }
}

// gb[off_w + i J + j] = -sum_r A(i, r) B(j, r) for i < I, j < J, and
// gb[off_b + j] = -sum_r B(j, r): A(i, r) = a[i * sa_i + r * sa_r], B(j, r) =
// bm[j * ldb + r]. 2 x 4 tiles of (i, j), the bias as row i = I of ones.
__device__ void bign_weight_grads(const float* a, int sa_i, int sa_r, int I, const float* bm,
                                  int ldb, int J, int R, float* gb, int off_w, int off_b) {
  const int ti = (I + 2) / 2, tj = (J + 3) / 4, items = ti * tj;
  const int g = group_lanes(items, R);
  // every thread runs the same rounds, so that a group's lanes meet in its shuffles
  for (int base = 0; base < items * g; base += blockDim.x) {
    const int item = (base + threadIdx.x) / g, part = (base + threadIdx.x) % g;
    const bool mine = item < items;
    const int i0 = 2 * (item / tj), j0 = 4 * (item % tj);
    float acc[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
    for (int r = part; mine && r < R; r += g) {
      float av[2], bv[4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
        av[u] = i0 + u < I ? a[(i0 + u) * sa_i + r * sa_r] : (i0 + u == I ? 1.f : 0.f);
#pragma unroll
      for (int v = 0; v < 4; ++v) bv[v] = j0 + v < J ? bm[(j0 + v) * ldb + r] : 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = group_total(acc[u][v], g);
    if (mine && part == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = i0 + u, j = j0 + v;
          if (j >= J) continue;
          if (i < I) gb[off_w + i * J + j] = -acc[u][v];
          if (i == I) gb[off_b + j] = -acc[u][v];
        }
    }
  }
}

// The deltas of layer l - 1 over its activations, from layer l's deltas:
// d_{l-1}(c, r) = sum_j d_l(j, r) W_l[c][j] (1 - a(c, r)^2), in tiles of TR
// rows x 4 units.
template <int TR>
__device__ void bign_layer_deltas(const float* th, const int* o, int l, int H, int R,
                                  float* act) {
  const int ld = R | 1;
  const float* cur = act + static_cast<size_t>(l) * H * ld;
  float* prev = act + static_cast<size_t>(l - 1) * H * ld;
  const float* w = th + o[2 * l];
  const int tr = (R + TR - 1) / TR, tc = (H + 3) / 4;
  for (int t = threadIdx.x; t < tr * tc; t += blockDim.x) {
    const int r0 = TR * (t % tr), c0 = 4 * (t / tr);
    float acc[TR][4];
#pragma unroll
    for (int u = 0; u < TR; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
    for (int j = 0; j < H; ++j) {
      float dv[TR], wv[4];
#pragma unroll
      for (int u = 0; u < TR; ++u) dv[u] = r0 + u < R ? cur[j * ld + r0 + u] : 0.f;
#pragma unroll
      for (int v = 0; v < 4; ++v) wv[v] = c0 + v < H ? w[(c0 + v) * H + j] : 0.f;
#pragma unroll
      for (int u = 0; u < TR; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(dv[u], wv[v], acc[u][v]);
    }
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int u = 0; u < TR; ++u)
        if (r0 + u < R && c0 + v < H) {
          float* q = prev + (c0 + v) * ld + r0 + u;
          const float av = *q;
          *q = acc[u][v] * (1.f - av * av);
        }
  }
}

// Backward of one net from dout [R] = d(sum ll)/d(output): minus the
// system's partial gradient of every leaf into gb; the activations are
// overwritten by their deltas. Ends with a barrier.
__device__ void bign_net_backward(const float* th, const int* o, int L, int H, int D,
                                  const float* xs, int R, float* act, const float* dout,
                                  float* gb) {
  const int tid = threadIdx.x, nth = blockDim.x, ld = R | 1;
  float* last = act + static_cast<size_t>(L - 1) * H * ld;
  // the output layer's weight and bias: rows of last against dout
  bign_weight_grads(last, ld, 1, H, dout, R, 1, R, gb, o[2 * L], o[2 * L + 1]);
  {
    const float* w = th + o[2 * L];
    __syncthreads();
    for (int e = tid; e < H * R; e += nth) {
      const int j = e / R, r = e % R;
      const float av = last[j * ld + r];
      last[j * ld + r] = dout[r] * w[j] * (1.f - av * av);
    }
    __syncthreads();
  }
  for (int l = L - 1; l >= 1; --l) {
    float* cur = act + static_cast<size_t>(l) * H * ld;       // [H][ld] deltas of layer l
    float* prev = act + static_cast<size_t>(l - 1) * H * ld;  // [H][ld] activations of l - 1
    bign_weight_grads(prev, ld, 1, H, cur, ld, H, R, gb, o[2 * l], o[2 * l + 1]);
    __syncthreads();
    if (R >= 64)
      bign_layer_deltas<4>(th, o, l, H, R, act);
    else
      bign_layer_deltas<1>(th, o, l, H, R, act);
    __syncthreads();
  }
  // the first layer: xs [R][D] against the deltas of layer 0
  bign_weight_grads(xs, 1, D, D, act, ld, H, R, gb, o[0], o[1]);
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
  const int H = wd[0];
  bign_net_forward(th, o_m, L, H, D, k.xs, N, k.act_m, k.outm);
  bign_net_forward(th, o_k, L, H, D, k.xs, N, k.act_k, k.outk);
  __syncthreads();
  const float sp_ls = softplus(th[off_ls]);
  bign_task_grad(k.outm, k.outk, k.ys, k.ms, N, sp_ls, softplus(th[off_nz]) + 1e-6f, w, k);
  bign_net_backward(th, o_m, L, H, D, k.xs, N, k.act_m, k.outm, gb);
  bign_net_backward(th, o_k, L, H, D, k.xs, N, k.act_k, k.outk, gb);
  if (tid == 0) {
    gb[off_ls] = -(k.hyp[0] * sigmoid(th[off_ls]));
    gb[off_nz] = -(k.hyp[1] * sigmoid(th[off_nz]));
  }
  const float ql = k.hyp[2];
  __syncthreads();
  return ql;
}
