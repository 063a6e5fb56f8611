// Both tanh MLPs of PACOH-MAP's GP prior (an NN mean with one output and an
// NN kernel with F, each of any depth and widths) over a block's R rows in
// register tiles: the passes of the fused MAP kernels where every hidden
// width is a multiple of the 4-unit tiles (csrc/fused_map_bign.cu, B9, and
// csrc/fused_map.cu, B6; the host plan sends other widths to map_nets.cuh's
// scalar passes). B10 and B11's passes (bign_score.cuh), generalised to
// per-layer widths and F outputs, both nets in each pass.
//
// The activations of layer l of a net are held transposed, [H_l][ld] at act
// + (H_0 + ... + H_{l-1}) ld, with an odd pitch ld >= R, so that the threads
// of a warp, walking the rows, read consecutive words and units 4 apart lie
// in different banks. The forward and the backward's deltas run in tiles of
// TR rows x 4 units (TR = 4 where there are rows enough to fill the block
// with them, else 2), each thread's operands in registers; the weight
// gradients (sums over the R rows) in 2 x 4 tiles whose rows a group of g
// lanes shares (group_lanes, group_total). Layer l of both nets shares one
// pass and one barrier. Every sum has one fixed order, no atomics.
//
// Included inside an anonymous namespace of each kernel's source, after
// lane_sums.cuh.

// One net of a pass: its leaf offsets o (w_0, b_0, ..., w_{L-1}, b_{L-1},
// w_out, b_out), hidden widths wd [L], outputs, activations and outputs
// [R][n_out].
struct TileNet {
  const int* o;
  const int* wd;
  int L, n_out;
  float* act;
  float* out;
  __device__ __forceinline__ size_t layer_off(int l) const {  // floats of layers before l, / ld
    size_t off = 0;
    for (int i = 0; i < l; ++i) off += wd[i];
    return off;
  }
};

// Layer l of one net as a pass sees it: weights, bias, input width, width,
// input (in(row, c) = in[c * si + row * sr]) and output.
struct TileLayer {
  const float* w;
  const float* b;
  int hp, H;
  const float* in;
  int si, sr;
  float* cur;
};

// Tile t (of ceil(R / TR) x ceil(H / 4)) of layer L: cur = tanh(b + in W).
template <int TR>
__device__ __forceinline__ void tile_forward(const float* w, const float* b, int hp, int H,
                                             const float* in, int si, int sr, int R, float* cur,
                                             int ld, int t) {
  const int tr = (R + TR - 1) / TR;
  const int r0 = TR * (t % tr), j0 = 4 * (t / tr);
  float acc[TR][4];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float bv = j0 + v < H ? b[j0 + v] : 0.f;
#pragma unroll
    for (int u = 0; u < TR; ++u) acc[u][v] = bv;
  }
#pragma unroll 4
  for (int c = 0; c < hp; ++c) {
    float a[TR], wv[4];
#pragma unroll
    for (int u = 0; u < TR; ++u) a[u] = r0 + u < R ? in[c * si + (r0 + u) * sr] : 0.f;
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

template <int TR>
__device__ void tile_nets_forward_tr(const float* th, const TileNet (&nets)[2], const float* xs,
                                     int D, int R, int ld) {
  const int tr = (R + TR - 1) / TR;
  TileLayer a{nullptr, nullptr, D, 0, xs, 1, D, nets[0].act};
  TileLayer b{nullptr, nullptr, D, 0, xs, 1, D, nets[1].act};
  const int depth = max(nets[0].L, nets[1].L);
  for (int l = 0; l < depth; ++l) {
    const bool ha = l < nets[0].L, hb = l < nets[1].L;
    if (ha) {
      a.w = th + nets[0].o[2 * l];
      a.b = th + nets[0].o[2 * l + 1];
      a.H = nets[0].wd[l];
    }
    if (hb) {
      b.w = th + nets[1].o[2 * l];
      b.b = th + nets[1].o[2 * l + 1];
      b.H = nets[1].wd[l];
    }
    const int na = ha ? tr * ((a.H + 3) / 4) : 0, nb = hb ? tr * ((b.H + 3) / 4) : 0;
    for (int t = threadIdx.x; t < na + nb; t += blockDim.x) {
      if (t < na)
        tile_forward<TR>(a.w, a.b, a.hp, a.H, a.in, a.si, a.sr, R, a.cur, ld, t);
      else
        tile_forward<TR>(b.w, b.b, b.hp, b.H, b.in, b.si, b.sr, R, b.cur, ld, t - na);
    }
    __syncthreads();
    if (ha) a = {nullptr, nullptr, a.H, 0, a.cur, ld, 1, a.cur + static_cast<size_t>(a.H) * ld};
    if (hb) b = {nullptr, nullptr, b.H, 0, b.cur, ld, 1, b.cur + static_cast<size_t>(b.H) * ld};
  }
  // both output layers: (row, output) a thread; a.in, b.in the last layers
  const int n0 = R * nets[0].n_out, n1 = R * nets[1].n_out;
  const float* wa = th + nets[0].o[2 * nets[0].L];
  const float* ba = th + nets[0].o[2 * nets[0].L + 1];
  const float* wb = th + nets[1].o[2 * nets[1].L];
  const float* bb = th + nets[1].o[2 * nets[1].L + 1];
  for (int e = threadIdx.x; e < n0 + n1; e += blockDim.x) {
    const bool second = e >= n0;
    const int ek = second ? e - n0 : e, n_out = second ? nets[1].n_out : nets[0].n_out;
    const int hp = second ? b.hp : a.hp;
    const float* last = second ? b.in : a.in;
    const float* w = second ? wb : wa;
    const int row = ek / n_out, q = ek % n_out;
    float s[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, units j = 4i + k in chain k
    for (int j = 0; j < hp; j += 4)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (j + k < hp) s[k] = fmaf(last[(j + k) * ld + row], w[(j + k) * n_out + q], s[k]);
    const float bias = (second ? bb : ba)[q];
    (second ? nets[1].out : nets[0].out)[ek] = ((s[0] + s[1]) + (s[2] + s[3])) + bias;
  }
  __syncthreads();
}

// Both nets at th over xs [R][D]: activations into nets[k].act, outputs into
// nets[k].out. Ends with a barrier.
__device__ void tile_nets_forward(const float* th, const TileNet (&nets)[2], const float* xs, int D,
                                  int R, int ld) {
  if (R >= 64)
    tile_nets_forward_tr<4>(th, nets, xs, D, R, ld);
  else
    tile_nets_forward_tr<2>(th, nets, xs, D, R, ld);
}

// One weight-gradient job: gb[off_w + i J + j] = -sum_r A(i, r) B(j, r) for
// i < I, j < J, and gb[off_b + j] = -sum_r B(j, r); A(i, r) = a[i * sa_i + r *
// sa_r], B(j, r) = bm[j * sb_j + r * sb_r]. 2 x 4 tiles of (i, j), the bias as
// row i = I of ones. An empty job has J = 0.
struct GradJob {
  const float* a;
  int sa_i, sa_r, I;
  const float* bm;
  int sb_j, sb_r, J, off_w, off_b;
  __device__ __forceinline__ int items() const { return J > 0 ? (I + 2) / 2 * ((J + 3) / 4) : 0; }
};

// Two jobs' items spread over the block, each summed over the R rows by g
// lanes in one fixed order. No barrier.
__device__ __forceinline__ void tile_weight_grads(const GradJob (&jobs)[2], int R, float* gb) {
  const int n0 = jobs[0].items(), items = n0 + jobs[1].items();
  const int g = group_lanes(items, R);
  // every thread runs the same rounds, so that a group's lanes meet in its shuffles
  for (int base = 0; base < items * g; base += blockDim.x) {
    const int item = (base + threadIdx.x) / g, part = (base + threadIdx.x) % g;
    const bool mine = item < items;
    const GradJob jb = item < n0 ? jobs[0] : jobs[1];
    const int it = item < n0 ? item : item - n0, tj = max(1, (jb.J + 3) / 4);
    const int i0 = 2 * (it / tj), j0 = 4 * (it % tj);
    float acc[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
    const float* pa[2];
    const float* pb[4];
    float one[2];  // the bias row's ones, 0 past it
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      pa[u] = i0 + u < jb.I ? jb.a + (i0 + u) * jb.sa_i : nullptr;
      one[u] = i0 + u == jb.I ? 1.f : 0.f;
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) pb[v] = j0 + v < jb.J ? jb.bm + (j0 + v) * jb.sb_j : nullptr;
    for (int r = part; mine && r < R; r += g) {
      float av[2], bv[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) av[u] = pa[u] != nullptr ? pa[u][r * jb.sa_r] : one[u];
#pragma unroll
      for (int v = 0; v < 4; ++v) bv[v] = pb[v] != nullptr ? pb[v][r * jb.sb_r] : 0.f;
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
          if (j >= jb.J) continue;
          if (i < jb.I) gb[jb.off_w + i * jb.J + j] = -acc[u][v];
          if (i == jb.I) gb[jb.off_b + j] = -acc[u][v];
        }
    }
  }
}

// Tile t of the deltas of layer l - 1 (width hp, prev [hp][ld], its
// activations on entry) from those of layer l (width H, cur [H][ld]) through
// W_l [hp][H]: prev(c, r) = sum_j cur(j, r) W_l[c][j] (1 - prev(c, r)^2).
template <int TR>
__device__ __forceinline__ void tile_deltas(const float* w, int hp, int H, const float* cur,
                                            float* prev, int R, int ld, int t) {
  const int tr = (R + TR - 1) / TR;
  const int r0 = TR * (t % tr), c0 = 4 * (t / tr);
  float acc[TR][4];
#pragma unroll
  for (int u = 0; u < TR; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
#pragma unroll 4
  for (int j = 0; j < H; ++j) {
    float dv[TR], wv[4];
#pragma unroll
    for (int u = 0; u < TR; ++u) dv[u] = r0 + u < R ? cur[j * ld + r0 + u] : 0.f;
#pragma unroll
    for (int v = 0; v < 4; ++v) wv[v] = c0 + v < hp ? w[(c0 + v) * H + j] : 0.f;
#pragma unroll
    for (int u = 0; u < TR; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(dv[u], wv[v], acc[u][v]);
  }
#pragma unroll
  for (int v = 0; v < 4; ++v)
#pragma unroll
    for (int u = 0; u < TR; ++u)
      if (r0 + u < R && c0 + v < hp) {
        float* q = prev + (c0 + v) * ld + r0 + u;
        const float av = *q;
        *q = acc[u][v] * (1.f - av * av);
      }
}

template <int TR>
__device__ void tile_nets_backward_tr(const float* th, const TileNet (&nets)[2], const float* xs,
                                      int D, int R, int ld, float* gb) {
  const int tid = threadIdx.x, nth = blockDim.x, tr = (R + TR - 1) / TR;
  const TileNet& A = nets[0];
  const TileNet& B = nets[1];
  float* cur_a = A.act + A.layer_off(A.L - 1) * ld;
  float* cur_b = B.act + B.layer_off(B.L - 1) * ld;
  const int hl_a = A.wd[A.L - 1], hl_b = B.wd[B.L - 1];
  {  // the output layers' weights and biases: the last layers against the outputs' deltas
    const GradJob jobs[2] = {{cur_a, ld, 1, hl_a, A.out, 1, A.n_out, A.n_out, A.o[2 * A.L],
                              A.o[2 * A.L + 1]},
                             {cur_b, ld, 1, hl_b, B.out, 1, B.n_out, B.n_out, B.o[2 * B.L],
                              B.o[2 * B.L + 1]}};
    tile_weight_grads(jobs, R, gb);
  }
  __syncthreads();
  // the last hidden layers' deltas: (unit, row) a thread
  const int n0 = hl_a * R;
  for (int e = tid; e < n0 + hl_b * R; e += nth) {
    const bool second = e >= n0;
    const int ek = second ? e - n0 : e, n_out = second ? B.n_out : A.n_out;
    const int j = ek / R, r = ek % R;
    const float* w = th + (second ? B.o[2 * B.L] : A.o[2 * A.L]);
    const float* dout = second ? B.out : A.out;
    float* cur = second ? cur_b : cur_a;
    float s = 0.f;
    for (int q = 0; q < n_out; ++q) s += dout[r * n_out + q] * w[j * n_out + q];
    const float av = cur[j * ld + r];
    cur[j * ld + r] = s * (1.f - av * av);
  }
  __syncthreads();
  // hidden layers from the deepest: layer l of each net that has it
  for (int l = max(A.L, B.L) - 1; l >= 1; --l) {
    const bool ha = l < A.L, hb = l < B.L;
    const int H_a = ha ? A.wd[l] : 0, hp_a = ha ? A.wd[l - 1] : 0;
    const int H_b = hb ? B.wd[l] : 0, hp_b = hb ? B.wd[l - 1] : 0;
    float* prev_a = ha ? cur_a - static_cast<size_t>(hp_a) * ld : cur_a;
    float* prev_b = hb ? cur_b - static_cast<size_t>(hp_b) * ld : cur_b;
    {
      const GradJob jobs[2] = {{prev_a, ld, 1, hp_a, cur_a, ld, 1, H_a, ha ? A.o[2 * l] : 0,
                                ha ? A.o[2 * l + 1] : 0},
                               {prev_b, ld, 1, hp_b, cur_b, ld, 1, H_b, hb ? B.o[2 * l] : 0,
                                hb ? B.o[2 * l + 1] : 0}};
      tile_weight_grads(jobs, R, gb);
    }
    __syncthreads();
    const int na = ha ? tr * ((hp_a + 3) / 4) : 0, nb = hb ? tr * ((hp_b + 3) / 4) : 0;
    const float* w_a = ha ? th + A.o[2 * l] : nullptr;
    const float* w_b = hb ? th + B.o[2 * l] : nullptr;
    for (int t = tid; t < na + nb; t += nth) {
      if (t < na)
        tile_deltas<TR>(w_a, hp_a, H_a, cur_a, prev_a, R, ld, t);
      else
        tile_deltas<TR>(w_b, hp_b, H_b, cur_b, prev_b, R, ld, t - na);
    }
    __syncthreads();
    cur_a = prev_a;
    cur_b = prev_b;
  }
  {  // the first layers: xs [R][D] against the deltas of layer 0
    const GradJob jobs[2] = {{xs, 1, D, D, A.act, ld, 1, A.wd[0], A.o[0], A.o[1]},
                             {xs, 1, D, D, B.act, ld, 1, B.wd[0], B.o[0], B.o[1]}};
    tile_weight_grads(jobs, R, gb);
  }
  __syncthreads();
}

// Backward of both nets from nets[k].out [R][n_out] = d(sum ll)/d(output):
// minus the rows' partial gradient of every leaf into gb; the activations
// are overwritten by their deltas. Ends with a barrier.
__device__ void tile_nets_backward(const float* th, const TileNet (&nets)[2], const float* xs,
                                   int D, int R, int ld, float* gb) {
  if (R >= 64)
    tile_nets_backward_tr<4>(th, nets, xs, D, R, ld, gb);
  else
    tile_nets_backward_tr<2>(th, nets, xs, D, R, ld, gb);
}
