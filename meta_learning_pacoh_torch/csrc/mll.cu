// Batched GP marginal-likelihood core for B independent N x N systems,
// forward and backward, each one warp a system.
//
// Replaces the Pallas TPU kernels of meta_learning_pacoh_tpu/ops/pallas/
// mll_kernel.py: _mll_fwd_kernel (launched by _mll_fwd_call) and
// _mll_bwd_kernel (launched by _mll_bwd_call).
//
//   forward:  L = chol(Kn + j I) for the first jitter j of (0, 1e-4, 1e-2)
//             whose factor has a finite positive diagonal (the last level is
//             taken regardless), chosen per system;
//             z = L^{-1} r,  quad = |z|^2,  logdet = 2 sum log diag L
//   backward: alpha = L^{-T} z,  W = L^{-1},
//             dKn = gl W^T W - gq alpha alpha^T,  dr = 2 gq alpha
//
// What bounds it on the card: at the general step's B=200, N=20 a system is
// 1.6 KB in and out and about 3e3 flops, so neither bytes nor flops do: the
// chain of N columns a system does. The TPU kernels put 128 systems in the
// lanes of one vector op. Here each system gets one warp, a block of its
// own, with no block barrier (several systems a block measured no faster at
// B=200 or 1000 on the H100).
//
// The forward runs warp_chol.cuh's register factorization: Kn arrives
// coalesced in a per-warp shared tile with an odd leading dimension, lane l
// takes row l (and row l + 32 for N > 32) into registers, each column's
// pivot is shuffled from its owner lane and the scaled column broadcast as
// float4 from a column buffer (factor_rows). r rides along as the border
// row, so z_j falls out as column j completes and no forward substitution
// follows. A pivot below FLT_MIN fails as 0 does; a failed pivot sends only
// its warp back to the tile (still holding Kn in its lower triangle) for the
// next jitter level. quad and logdet are warp sums; L goes out through the
// tile (its columns collected in the upper triangle), lower with zeros
// above, coalesced.
//
// The backward gives lane c the columns c and c + 32 of W = L^-1: L lands
// transposed in shared memory (L^T, a column of L a row), and lane c solves
// L w = e_c by the right-looking sweep in registers, L's column j read as
// float4 broadcasts, with no exchange between lanes; the finished rows go to
// a W^T tile. alpha = W^T z is each lane's dot with z; K^-1 = W^T W row by
// row, each lane's own column against column a's float4 broadcasts, and
// dKn's row a leaves across the lanes. The register arrays of both kernels
// are indexed only by unrolled loop indices, one instance for N <= 32 and
// one for 33 <= N <= 64. What holds each now is its warp's chain of N
// columns.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

#include "warp_chol.cuh"

constexpr int kMaxN = 64;

// For N <= 32 at most 64 registers a thread (32 blocks an SM): with the
// allocation left free (93 registers) the factorization measured 13% slower
// at N=20 on the H100.
template <int R>
__global__ void __launch_bounds__(32, R == 1 ? 32 : 1)
mll_fwd_warp_kernel(const float* __restrict__ kn, const float* __restrict__ r,
                    float* __restrict__ quad, float* __restrict__ logdet,
                    float* __restrict__ l_out, float* __restrict__ z_out, int n) {
  extern __shared__ __align__(16) float tile[];  // the system's tile, then its column buffers
  const int lane = threadIdx.x;
  const long long sys = blockIdx.x;
  const int ld = n | 1;  // odd: the lanes reading down a column hit 32 banks
  float* colbuf = tile + (n * ld + 3) / 4 * 4;  // two column buffers, 16-byte aligned
  const size_t nn = static_cast<size_t>(n) * n;
  const float* src = kn + sys * nn;
  // Kn's rows into the tile, coalesced, eight rows' loads in flight
  for (int i0 = 0; i0 < n; i0 += 8) {
    float v[8][R];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int s = 0; s < R; ++s)
        v[u][s] = i0 + u < n && lane + 32 * s < n ? src[(i0 + u) * n + lane + 32 * s] : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int s = 0; s < R; ++s)
        if (i0 + u < n && lane + 32 * s < n) tile[(i0 + u) * ld + lane + 32 * s] = v[u][s];
  }
  __syncwarp();

  float a[R][32 * R], w[R], dg[R];
#pragma unroll 1
  for (int level = 0; level < 3; ++level) {
    const float jit = level == 0 ? 0.f : (level == 1 ? 1e-4f : 1e-2f);
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int row = lane + 32 * s;
#pragma unroll
      for (int c = 0; c < 32 * (s + 1); ++c)
        a[s][c] = row < n && c <= row ? tile[row * ld + c] + (c == row ? jit : 0.f) : 0.f;
      w[s] = row < n ? r[sys * n + row] : 0.f;
      dg[s] = 1.f;
    }
    if (factor_rows<R, true, NormalPivots>(a, w, dg, tile, colbuf, ld, n, lane, level == 2)) break;
  }

  float q = 0.f, ldet = 0.f;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int row = lane + 32 * s;
    if (row < n) {
      q += w[s] * w[s];
      ldet += logf(dg[s]);
      z_out[sys * n + row] = w[s];
      tile[row * ld + row] = dg[s];  // Kn's diagonal is no longer needed
    }
  }
  q = warp_sum(q);
  ldet = warp_sum(ldet);
  if (lane == 0) {
    quad[sys] = q;
    logdet[sys] = 2.f * ldet;
  }
  // L's rows out coalesced from the tile's upper triangle, zeros above
  __syncwarp();
  float* dst = l_out + sys * nn;
#pragma unroll 4
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int c = lane + 32 * s;
      if (c < n) dst[i * n + c] = c <= i ? tile[c * ld + i] : 0.f;
    }
}

// The backward's tiles, L^T and W^T (one row a column of L or W): their
// leading dimension is N rounded up to 4, made four times an odd number, so
// a tile row's float4s are 16-byte aligned, and 8 lanes on 8 rows start on
// 8 different multiples of 4 banks: a quarter warp's float4s of its own rows
// of W^T, and a warp's 4 x 8 copies into L^T, hit 32 banks.
__host__ __device__ __forceinline__ int bwd_ld(int n) { return 4 * (((n + 3) / 4) | 1); }

// Shared floats of one backward system: L^T and W^T, then z, 1 / diag L and
// alpha (one leading dimension each).
__host__ __device__ __forceinline__ int bwd_floats(int n) { return (2 * n + 3) * bwd_ld(n); }

__device__ __forceinline__ float4 load4_or_zero(const float* p, bool take) {
  return take ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// K3's loops read float4s in spans of Span rows under one uniform guard a
// span: each group of four under a guard of its own waits for its load
// behind its own branch, the loads of a step queued one after another; a
// span's loads are predicated (0 where the group is outside the guard's
// rows) and issue together before its FMAs.
//
// Lane c's C columns of W = L^-1 (c and c + 32) by the right-looking sweep
// over L's columns j in [j_begin, j_end): w_j *= 1 / L_jj, then
// w_k -= L_kj w_j for k > j. w[q][k] is row j0 + k of the q-th column: a
// window that slides four rows a pass, as factor_rows' does, so the arrays
// are indexed only by unrolled loop indices. L's column j comes from row j
// of the L^T tile as float4 broadcasts (every lane the same address), zero
// below row N; the lanes never talk to each other, so no __syncwarp. Each
// pass's four finished rows go to the lane's row of the W^T tile as one
// float4.
template <int C, int S, int Span>
__device__ __forceinline__ void sweep_columns(float (&w)[C][S], const float* lt, const float* dinv,
                                              float* wt, int ld, int j_begin, int j_end, int n,
                                              int lane) {
#pragma unroll 1
  for (int j0 = j_begin; j0 < j_end; j0 += 4) {
    const float4 d4 = *reinterpret_cast<const float4*>(dinv + j0);
    const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (j0 + u < n) {
        const float* lcol = lt + (j0 + u) * ld + j0;  // lcol[k] = L[j0 + k][j0 + u]
#pragma unroll
        for (int q = 0; q < C; ++q) w[q][u] *= dv[u];
#pragma unroll
        for (int k1 = 0; k1 < S; k1 += Span) {
          if (k1 + Span - 1 > u && j0 + k1 < n) {  // the span holds rows below j, in the matrix
            float4 l4[Span / 4];
#pragma unroll
            for (int g = 0; g < Span / 4; ++g)
              l4[g] = load4_or_zero(lcol + k1 + 4 * g, k1 + 4 * g + 3 > u && j0 + k1 + 4 * g < n);
#pragma unroll
            for (int g = 0; g < Span / 4; ++g) {
              const float lk[4] = {l4[g].x, l4[g].y, l4[g].z, l4[g].w};
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (k1 + 4 * g + e > u)
#pragma unroll
                  for (int q = 0; q < C; ++q) w[q][k1 + 4 * g + e] -= lk[e] * w[q][u];
            }
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int row = lane + 32 * q;  // the lane's column of W, its row of W^T
      if (row < n)
        *reinterpret_cast<float4*>(wt + row * ld + j0) =
            make_float4(w[q][0], w[q][1], w[q][2], w[q][3]);
#pragma unroll
      for (int k = 0; k < S; ++k) w[q][k] = k + 4 < S ? w[q][k + 4] : 0.f;
    }
  }
}

// One system a warp, a block of its own, lane b owning columns b and b + 32
// of W and of K^-1. L's lower triangle lands transposed in the L^T tile by
// cp.async (lane (p, q) of a 4 x 8 pattern copies L[i0 + q][c0 + p]: 32-byte
// runs of a row from device memory, 32 banks in shared memory), zeros above
// and beyond row N; z beside it. W by columns (sweep_columns); alpha = W^T z,
// the lane's column against z's float4 broadcasts; K^-1 = W^T W row by row:
// for row a the lane dots its own column (in registers) with column a, read
// from the W^T tile as float4 broadcasts from row a's first nonzero group
// on, in four partial sums by k mod 4, so (a, b) and (b, a) sum the same
// nonzero products in the same order and dKn comes out exactly symmetric.
// Row a of dKn leaves across the lanes, coalesced.
//
// No register cap, spans of 16 rows (N <= 32) or 32: on the H100 at N=20
// the cap of 64 registers spilled and read 0.0085 ms against 0.0078
// without; spans of 32 read 0.0081 at N=20 and 0.0203 against 0.0210 at
// N=48.
template <int R>
__global__ void __launch_bounds__(32)
mll_bwd_warp_kernel(const float* __restrict__ l_in, const float* __restrict__ z_in,
                    const float* __restrict__ gq, const float* __restrict__ gl,
                    float* __restrict__ dkn, float* __restrict__ dr, int n) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  const long long sys = blockIdx.x;
  const int ld = bwd_ld(n), n4 = (n + 3) / 4 * 4;
  float* lt = smem;             // lt[j * ld + k] = L[k][j]
  float* wt = lt + n * ld;      // wt[c * ld + k] = W[k][c]
  float* zs = wt + n * ld;      // z, zero beyond N
  float* dinv = zs + ld;        // 1 / L_kk, zero beyond N
  float* alpha = dinv + ld;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* ls = l_in + sys * nn;
  const float* zsrc = z_in + sys * n;
  const float g_q = gq[sys], g_l = gl[sys];
  constexpr int Span = 16 * R;

  const int p = lane >> 2, q4 = lane & 3;
  for (int i0 = 0; i0 < n4; i0 += 4) {
    const int i = i0 + q4;
    for (int c0 = 0; c0 <= i0 + 3 && c0 < n; c0 += 8) {
      const int c = c0 + p;
      const bool take = i < n && c <= i;
      if (c < n) cp_async4(lt + c * ld + i, take ? ls + i * n + c : ls, take);
    }
  }
  for (int k = lane; k < n4; k += 32) cp_async4(zs + k, zsrc + (k < n ? k : 0), k < n);
  cp_async_wait_all();
  __syncwarp();
  for (int k = lane; k < n4; k += 32) dinv[k] = k < n ? 1.f / lt[k * ld + k] : 0.f;
  __syncwarp();

  if constexpr (R == 1) {
    float w[1][32];
#pragma unroll
    for (int k = 0; k < 32; ++k) w[0][k] = k == lane ? 1.f : 0.f;
    sweep_columns<1, 32, Span>(w, lt, dinv, wt, ld, 0, n, n, lane);
  } else {
    // columns 0-31 alone down to row 32, then with columns 32-63
    float wa[1][64];
#pragma unroll
    for (int k = 0; k < 64; ++k) wa[0][k] = k == lane ? 1.f : 0.f;
    sweep_columns<1, 64, Span>(wa, lt, dinv, wt, ld, 0, 32, n, lane);
    float wb[2][32];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      wb[0][k] = wa[0][k];
      wb[1][k] = k == lane ? 1.f : 0.f;
    }
    sweep_columns<2, 32, Span>(wb, lt, dinv, wt, ld, 32, n, n, lane);
  }
  __syncwarp();

  // own[q][k]: row k of the lane's column lane + 32 q (zero above it)
  float own[R][32 * R], al[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int col = lane + 32 * q;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k0 = 32 * q; k0 < 32 * R; k0 += 4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 < n) {
        if (col < n) v = *reinterpret_cast<const float4*>(wt + col * ld + k0);
        const float4 zv = *reinterpret_cast<const float4*>(zs + k0);
        part[0] += v.x * zv.x;
        part[1] += v.y * zv.y;
        part[2] += v.z * zv.z;
        part[3] += v.w * zv.w;
      }
      own[q][k0] = v.x;
      own[q][k0 + 1] = v.y;
      own[q][k0 + 2] = v.z;
      own[q][k0 + 3] = v.w;
    }
    al[q] = (part[0] + part[1]) + (part[2] + part[3]);  // alpha = W^T z
    if (col < n) {
      alpha[col] = al[q];
      dr[sys * n + col] = 2.f * g_q * al[q];
    }
  }
  __syncwarp();

  float* out = dkn + sys * nn;
#pragma unroll 1
  for (int a = 0; a < n; ++a) {
    const float* wa = wt + a * ld;  // column a of W, zero above row a
    float part[R][4];
#pragma unroll
    for (int q = 0; q < R; ++q) part[q][0] = part[q][1] = part[q][2] = part[q][3] = 0.f;
#pragma unroll
    for (int k1 = 0; k1 < 32 * R; k1 += Span) {
      if (k1 + Span - 1 >= a && k1 < n) {  // the span holds rows from a on, in the matrix
        float4 v[Span / 4];
#pragma unroll
        for (int g = 0; g < Span / 4; ++g) {
          const int k0 = k1 + 4 * g;
          v[g] = load4_or_zero(wa + k0, k0 + 3 >= a && k0 < n);
        }
#pragma unroll
        for (int g = 0; g < Span / 4; ++g) {
          const int k0 = k1 + 4 * g;
#pragma unroll
          for (int q = 0; q < R; ++q)
            if (k0 >= 32 * q) {
              part[q][0] += v[g].x * own[q][k0];
              part[q][1] += v[g].y * own[q][k0 + 1];
              part[q][2] += v[g].z * own[q][k0 + 2];
              part[q][3] += v[g].w * own[q][k0 + 3];
            }
        }
      }
    }
    const float alpha_a = alpha[a];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int col = lane + 32 * q;
      const float kinv = (part[q][0] + part[q][1]) + (part[q][2] + part[q][3]);
      if (col < n) out[a * n + col] = g_l * kinv - g_q * (alpha_a * al[q]);
    }
  }
}

}  // namespace

extern "C" int pacoh_mll_fwd(const float* kn, const float* r, float* quad, float* logdet,
                             float* l_out, float* z_out, int b, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(warp_floats(n)) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 32)
    mll_fwd_warp_kernel<1><<<b, 32, bytes, st>>>(kn, r, quad, logdet, l_out, z_out, n);
  else
    mll_fwd_warp_kernel<2><<<b, 32, bytes, st>>>(kn, r, quad, logdet, l_out, z_out, n);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local-memory bytes a thread (where spills and stack frames
// go) of the forward's instance for N <= 32 (wide = 0) or 33 <= N <= 64.
extern "C" int pacoh_mll_fwd_usage(int wide, int* out, int device, void* stream) {
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = wide ? cudaFuncGetAttributes(&attr, mll_fwd_warp_kernel<2>)
             : cudaFuncGetAttributes(&attr, mll_fwd_warp_kernel<1>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

extern "C" int pacoh_mll_bwd(const float* l, const float* z, const float* gq,
                             const float* gl, float* dkn, float* dr, int b, int n,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(bwd_floats(n)) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 32)
    mll_bwd_warp_kernel<1><<<b, 32, bytes, st>>>(l, z, gq, gl, dkn, dr, n);
  else
    mll_bwd_warp_kernel<2><<<b, 32, bytes, st>>>(l, z, gq, gl, dkn, dr, n);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local-memory bytes a thread of the backward's instance for
// N <= 32 (wide = 0) or 33 <= N <= 64.
extern "C" int pacoh_mll_bwd_usage(int wide, int* out, int device, void* stream) {
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = wide ? cudaFuncGetAttributes(&attr, mll_bwd_warp_kernel<2>)
             : cudaFuncGetAttributes(&attr, mll_bwd_warp_kernel<1>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
