// Batched GP marginal-likelihood core for B independent N x N systems,
// forward (one warp per system) and backward (one block per system).
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
// chain of N pivots a system does. The TPU kernel put 128 systems in the
// lanes of one vector op. The forward here gives each system one warp, a
// block of its own, with no block barrier (several systems a block measured
// no faster at B=200 or 1000 on the H100): Kn arrives coalesced in a
// per-warp shared tile with an odd leading dimension, lane l
// takes row l (and row l + 32 for N > 32) into registers, and the
// right-looking factorization runs there: column j's pivot comes from its
// owner lane by shuffle, each lane scales its entry, and the trailing update
// reads the scaled column back from a per-warp buffer as float4 broadcasts
// (factor_rows). r rides along as the border row: lane l carries r_l
// through the same updates, so z_j falls out as column j completes and no
// forward substitution follows. A failed pivot sends only its warp back to
// the tile (still holding Kn in its lower triangle) for the next jitter
// level. quad and logdet are warp sums; L goes out through the tile (its
// columns collected in the upper triangle), lower with zeros above,
// coalesced. The register arrays are indexed only by unrolled loop indices,
// one instance for N <= 32 and one for 33 <= N <= 64. What holds it now is
// that one warp's chain of N columns. The backward stays the first design:
// one block a system in shared memory, its threads sharing each column.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kThreads = 128;             // the backward's block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kColBuf = 64;               // floats of a column buffer (N <= 64)

// Shared floats of one forward system: its N x (N | 1) tile, rounded up to 16
// bytes, and two column buffers.
__host__ __device__ __forceinline__ int warp_floats(int n) {
  return (n * (n | 1) + 3) / 4 * 4 + 2 * kColBuf;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// 1 / sqrt(d) by the hardware's approximation, off the pivot chain's
// denormal rescaling: it flushes a pivot below FLT_MIN (2^-126) to 0, so
// factor_rows takes such a pivot as failed, as it takes 0 (the GP systems
// here carry a noise floor far above).
__device__ __forceinline__ float rsqrt_approx(float d) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return r;
}

// The factorization of one system in one warp's registers, r as its border
// row. a[s][k] is row lane + 32 s, column j0 + k: a window that slides U
// columns at the end of each pass of the column loop, so the arrays are
// indexed only by unrolled loop indices while the loop over the columns
// stays a loop, whose body stays in the instruction cache (fully unrolled,
// the columns streamed as code once a system). Column j's entries below the
// pivot go through a per-warp column buffer in shared memory (two,
// alternating, so one __syncwarp a column orders them): every lane reads
// them back as float4 broadcasts. The trailing update runs in groups of G
// columns (8; 4 for N > 32, which keeps that instance's registers from
// spilling) under one uniform guard a group. Each row also updates its own
// next diagonal entry from its own L entry (dn: the value the group update
// gives it, bit for bit), so the next pivot's shuffle does not wait on the
// column buffer. Entries above the diagonal carry values that are never
// read. w[s] is the row's entry of the border row. Column j of L also goes
// to the tile transposed, into its upper triangle (L[row][j] at
// tile[j][row]), which the reload of a later jitter level does not read.
// Returns whether every pivot was finite and at least FLT_MIN; unless
// `last`, it stops at the first that is not. On return w[s] holds z and
// dg[s] the diagonal of the rows.
template <int R>
__device__ __forceinline__ bool factor_rows(float (&a)[R][32 * R], float (&w)[R], float (&dg)[R],
                                            float* tile, float* colbuf, int ld, int n, int lane,
                                            bool last) {
  constexpr int U = 4;
  constexpr int G = 8 / R;
  float dn[R];
#pragma unroll
  for (int s = 0; s < R; ++s) dn[s] = a[s][0];
#pragma unroll 1
  for (int j0 = 0; j0 < n; j0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u;
      if (j < n) {
        const bool wide = R == 2 && j >= 32;  // column j's row is in the second set
        const float d = __shfl_sync(kFull, wide ? dn[R - 1] : dn[0], j & 31);
        if (!last && !(d >= FLT_MIN && d < INFINITY)) return false;
        const float inv = rsqrt_approx(d);
        const float zj = __shfl_sync(kFull, wide ? w[R - 1] : w[0], j & 31) * inv;
        float* col = colbuf + (j & 1) * kColBuf;  // col[c] = L[j + c][j]
        float lj[R];
#pragma unroll
        for (int s = 0; s < R; ++s) {
          const int row = lane + 32 * s;
          const float l = a[s][u] * inv;  // L[row][j] for the rows below j
          if (row > j) {
            col[row - j] = l;
            if (row < n) tile[j * ld + row] = l;
          }
          dg[s] = row == j ? d * inv : dg[s];
          w[s] = row == j ? zj : (row > j ? w[s] - l * zj : w[s]);
          lj[s] = l;
          dn[s] = a[s][u + 1] - l * l;
        }
        __syncwarp();
#pragma unroll
        for (int c0 = 0; c0 < 32 * R; c0 += G) {
          if (j + (c0 > 0 ? c0 : 1) < n) {  // the group's first column is in the matrix
            float lc[G];
#pragma unroll
            for (int v = 0; v < G / 4; ++v) {
              const float4 q = reinterpret_cast<const float4*>(col)[c0 / 4 + v];
              lc[4 * v] = q.x;
              lc[4 * v + 1] = q.y;
              lc[4 * v + 2] = q.z;
              lc[4 * v + 3] = q.w;
            }
#pragma unroll
            for (int e = 0; e < G; ++e) {
#pragma unroll
              for (int s = 0; s < R; ++s)
                if (c0 + e > 0 && u + c0 + e < 32 * (s + 1) && (s > 0 || j < 32))
                  a[s][u + c0 + e] -= lj[s] * lc[e];
            }
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {
#pragma unroll
      for (int k = 0; k + U < 32 * (s + 1); ++k) a[s][k] = a[s][k + U];
    }
  }
  return true;
}

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
    if (factor_rows<R>(a, w, dg, tile, colbuf, ld, n, lane, level == 2)) break;
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

__global__ void __launch_bounds__(kThreads)
mll_bwd_kernel(const float* __restrict__ l_in, const float* __restrict__ z_in,
               const float* __restrict__ gq, const float* __restrict__ gl,
               float* __restrict__ dkn, float* __restrict__ dr, int n) {
  extern __shared__ float smem[];
  float* l = smem;            // n * n
  float* w = l + n * n;       // n * n, W = L^{-1} (lower)
  float* alpha = w + n * n;   // n

  const int sys = blockIdx.x;
  const int tid = threadIdx.x;
  const float* ls = l_in + static_cast<size_t>(sys) * n * n;
  const float* zs = z_in + static_cast<size_t>(sys) * n;
  for (int idx = tid; idx < n * n; idx += blockDim.x) l[idx] = ls[idx];
  __syncthreads();

  // alpha = L^{-T} z by back substitution in warp 0.
  if (tid < 32) {
    for (int i = n - 1; i >= 0; --i) {
      float part = 0.f;
      for (int k = i + 1 + tid; k < n; k += 32) part += l[k * n + i] * alpha[k];
      part = warp_sum(part);
      if (tid == 0) alpha[i] = (zs[i] - part) / l[i * n + i];
      __syncwarp();
    }
  }
  // W = L^{-1}: thread c solves L w = e_c for column c (zero above row c).
  for (int c = tid; c < n; c += blockDim.x) {
    for (int i = 0; i < c; ++i) w[i * n + c] = 0.f;
    for (int i = c; i < n; ++i) {
      float acc = (i == c) ? 1.f : 0.f;
      for (int k = c; k < i; ++k) acc -= l[i * n + k] * w[k * n + c];
      w[i * n + c] = acc / l[i * n + i];
    }
  }
  __syncthreads();

  const float g_q = gq[sys], g_l = gl[sys];
  float* out = dkn + static_cast<size_t>(sys) * n * n;
  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const int a = idx / n, b = idx % n;
    float kinv = 0.f;
    for (int k = (a > b ? a : b); k < n; ++k) kinv += w[k * n + a] * w[k * n + b];
    out[idx] = g_l * kinv - g_q * alpha[a] * alpha[b];
  }
  for (int i = tid; i < n; i += blockDim.x)
    dr[static_cast<size_t>(sys) * n + i] = 2.f * g_q * alpha[i];
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
  const size_t smem = static_cast<size_t>(2 * n * n + n) * sizeof(float);
  mll_bwd_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      l, z, gq, gl, dkn, dr, n);
  return static_cast<int>(cudaGetLastError());
}
