// Blocked GP marginal-likelihood core for B independent N x N systems,
// 49 <= N <= 512, forward and backward, one block per system.
//
// Replaces the Pallas TPU kernels of meta_learning_pacoh_tpu/ops/pallas/
// blocked_mll_kernel.py: _mll_fwd_kernel (launched by _blocked_fwd_call)
// and _mll_bwd_kernel (launched by _blocked_bwd_call), the custom VJP
// blocked_mll_quad_logdet.
//
//   forward:  L = chol(Kn + j I) at the first jitter j of (0, 1e-4, 1e-2)
//             whose factorization succeeds (every pivot finite and
//             positive), chosen per system, the jitter on the whole
//             diagonal; a system that fails at every level comes back NaN.
//             z = L^-1 r,  quad = |z|^2,  logdet = 2 sum log diag L
//   backward: W = L^-1, alpha = W^T z,
//             dKn = gl W^T W - gq alpha alpha^T,  dr = 2 gq alpha
//
// What bounds it on the card: at bench.py's B=200, N=200 a system is 160 KB
// and about N^3/3 flops forward (the factor) and N^3/2 backward (the
// inverse, N^3/6, and K^-1, N^3/3), 1-1.3 GFLOP in all against 64 MB each
// way: the card's bound is about 20 us (bytes). Both are far from it: one
// block per system walks a factorization's chain of dependent steps.
//
// The forward factors with the tiled design of csrc/tiled_chol.cuh: panels
// of 32 columns at three barriers each, trailing updates from register
// micro-tiles, the lower triangle packed in shared memory so that two
// blocks share an SM up to N=207 (bench.py's 200 systems run in one wave of
// 264 slots), loaded by cp.async, and r carried as the border row N, so
// that z = L^-1 r comes out of the factorization with no serial forward
// substitution. Each escalation level reloads the pristine system; the
// jitter goes on the whole diagonal as each diagonal tile is factored. Up
// to N=307 the triangle is in shared memory; above, the block works in
// place in its output L in device memory (L2-resident) and in z.
//
// The backward runs the tiled inverse of csrc/tiled_inverse.cuh (the system
// algebra of B9, B10 and B11) on the forward's factor: one block of 512
// threads a system loads L's lower triangle (packed in shared memory by
// cp.async up to N=306, above in place in the block's own output square in
// device memory, L2-resident), inverts it in 32-column panels (W = L^-1),
// forms alpha = W^T z, turns W into K^-1 = W^T W in place (block rows of
// register micro-tiles) and writes dKn whole, both triangles from one value
// each, so dKn is exactly symmetric. Where a batch has more systems than
// the card has SMs, two blocks share an SM up to N=206 (bench.py's 200
// systems run in one wave), at 64 registers a thread, which spill; a
// smaller batch (the general steps' 5 and 50) runs one block an SM with
// the registers it needs: at N=200 on an H100, 0.15 ms at B=5 against 0.18
// for the two-block instance, and 0.28 ms at B=200 against 0.30 for the
// one-block instance in two waves. A system that came out of the
// forward as NaN stays NaN. The first design inverted a column at a time
// and formed dKn a row at a time (a barrier and a serial N-term dot an
// entry): 1.74 ms at B=200, N=200 on an H100, above its plain version's
// 0.94 ms.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;      // the backward, tiled_inverse.cuh's thread count
constexpr int kFwdThreads = 256;   // the forward, two blocks an SM
constexpr int kMaxN = 512;

#include "tiled_chol.cuh"
#include "tiled_inverse.cuh"

constexpr int kBwdTiles = kMaxN / kTile;  // diagonal tiles of the largest system

// Shared-memory floats of a backward block: the tiled passes' scratch, z,
// alpha and the diagonal tiles' log sums, then, where it is held there, the
// packed lower triangle; ops/cuda/blocked_mll_kernel.py (bwd_shared_bytes)
// states the same.
size_t bwd_floats(int n, bool packed) {
  return tiled_scratch_floats(n, n) + 2 * static_cast<size_t>(round4(n)) + kBwdTiles +
         (packed ? packed_off(n) : 0);
}

__global__ void __launch_bounds__(kFwdThreads, 2)
blocked_fwd_kernel(const float* __restrict__ kn, const float* __restrict__ r,
                   float* __restrict__ quad, float* __restrict__ logdet,
                   float* __restrict__ l_out, float* __restrict__ z_out, int n, int packed) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int sys = blockIdx.x, tid = threadIdx.x;
  const size_t base = static_cast<size_t>(sys) * n * n;
  float* dst = l_out + base;
  float* z = z_out + static_cast<size_t>(sys) * n;
  const float* rs = r + static_cast<size_t>(sys) * n;
  // the system with r as its border row N
  const TiledMatrix m{packed ? smem + tiled_scratch_floats(n, n + 1) : dst, z, n, n + 1,
                      packed != 0};
  bool ok = false;
  for (int level = 0; level < 3 && !ok; ++level) {
    tiled_load(m, kn + base, rs);
    ok = tiled_factor(m, level == 0 ? 0.f : (level == 1 ? 1e-4f : 1e-2f), smem);
  }
  const float* zr = m.row(n);
  if (tid < 32) {  // quad = |z|^2, logdet = 2 sum log diag L, in one fixed order
    float q = 0.f, s = 0.f;
    for (int i = tid; ok && i < n; i += 32) {
      q += zr[i] * zr[i];
      s += logf(m.row(i)[i]);
    }
    q = warp_total(q);
    s = warp_total(s);
    if (tid == 0) {
      quad[sys] = ok ? q : nanf("");
      logdet[sys] = ok ? 2.f * s : nanf("");
    }
  }
  __syncthreads();
  tiled_store(m, dst, ok);
  if (packed || !ok)
    for (int i = tid; i < n; i += blockDim.x) z[i] = ok ? zr[i] : nanf("");
}

// kMinBlocks: the resident blocks an SM that the register budget is cut for
// (2 where the shared memory holds two).
template <int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
blocked_bwd_kernel(const float* __restrict__ l_in, const float* __restrict__ z_in,
                   const float* __restrict__ gq, const float* __restrict__ gl,
                   float* __restrict__ dkn, float* __restrict__ dr, int n, int packed) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int sys = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nth >> 5;
  const size_t base = static_cast<size_t>(sys) * n * n;
  float* out = dkn + base;
  float* z = smem + tiled_scratch_floats(n, n);
  float* alpha = z + round4(n);
  float* tile_log = alpha + round4(n);
  // W, then K^-1, in place: packed in shared memory, or in the output square
  const TiledMatrix m{packed ? tile_log + kBwdTiles : out, nullptr, n, n, packed != 0};
  for (int i = tid; i < n; i += nth) z[i] = z_in[static_cast<size_t>(sys) * n + i];
  tiled_load(m, l_in + base, nullptr);
  tiled_invert(m, smem, tile_log);
  tiled_wt_times(m, z, alpha);
  tiled_lauum(m);

  const float g_q = gq[sys], g_l = gl[sys];
  for (int i = tid; i < n; i += nth) dr[static_cast<size_t>(sys) * n + i] = 2.f * g_q * alpha[i];
  // dKn_ab = g_l K^-1_ab - g_q (alpha_a alpha_b), K^-1 from its lower triangle
  if (packed) {  // a warp an output row, lanes along it
    for (int a = warp; a < n; a += n_warps) {
      const float* row_a = m.row(a);
      const float al_a = alpha[a];
      for (int b = lane; b < n; b += 32) {
        const float kinv = b <= a ? row_a[b] : m.row(b)[a];
        out[static_cast<size_t>(a) * n + b] = g_l * kinv - g_q * (al_a * alpha[b]);
      }
    }
  } else {  // in place: each lower entry read once, then written with its mirror
    for (int a = warp; a < n; a += n_warps) {
      float* row_a = out + static_cast<size_t>(a) * n;
      const float al_a = alpha[a];
      for (int b = lane; b <= a; b += 32) {
        const float v = g_l * row_a[b] - g_q * (al_a * alpha[b]);
        row_a[b] = v;
        out[static_cast<size_t>(b) * n + a] = v;
      }
    }
  }
}

// Whether the packed triangle fits (*packed), a block's dynamic shared
// memory (*dyn), and whether two blocks share an SM (*two) for a batch of b
// systems; sets the attributes of the instance that runs.
int bwd_setup(int n, int b, int device, int* packed, size_t* dyn, int* two) {
  int optin = 0, per_sm = 0, n_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *packed = bwd_floats(n, true) * sizeof(float) <= static_cast<size_t>(optin);
  *dyn = bwd_floats(n, *packed != 0) * sizeof(float);
  // an SM keeps 1 KB of its shared memory for each resident block
  *two = *packed && b > n_sm && 2 * (*dyn + 1024) <= static_cast<size_t>(per_sm);
  const void* kernel = *two ? reinterpret_cast<const void*>(blocked_bwd_kernel<2>)
                            : reinterpret_cast<const void*>(blocked_bwd_kernel<1>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(*dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(err);
}

}  // namespace

extern "C" int pacoh_blocked_mll_fwd(const float* kn, const float* r, float* quad, float* logdet,
                                     float* l_out, float* z_out, int b, int n, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  int packed = 0;
  size_t dyn = 0;
  const int e = tiled_setup(blocked_fwd_kernel, n, n + 1, device, &packed, &dyn);
  if (e != 0) return e;
  blocked_fwd_kernel<<<b, kFwdThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      kn, r, quad, logdet, l_out, z_out, n, packed);
  return static_cast<int>(cudaGetLastError());
}

// Resident forward blocks per SM at this N, into *blocks.
extern "C" int pacoh_blocked_mll_fwd_blocks_per_sm(int n, int* blocks, int device, void* stream) {
  (void)stream;
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  return tiled_blocks_per_sm(blocked_fwd_kernel, kFwdThreads, n, n + 1, device, blocks);
}

extern "C" int pacoh_blocked_mll_bwd(const float* l, const float* z, const float* gq,
                                     const float* gl, float* dkn, float* dr, int b, int n,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  int packed = 0, two = 0;
  size_t dyn = 0;
  const int e = bwd_setup(n, b, device, &packed, &dyn, &two);
  if (e != 0) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (two)
    blocked_bwd_kernel<2><<<b, kThreads, dyn, s>>>(l, z, gq, gl, dkn, dr, n, packed);
  else
    blocked_bwd_kernel<1><<<b, kThreads, dyn, s>>>(l, z, gq, gl, dkn, dr, n, packed);
  return static_cast<int>(cudaGetLastError());
}

// Resident backward blocks per SM at this N for a batch of more systems
// than SMs, into *blocks.
extern "C" int pacoh_blocked_mll_bwd_blocks_per_sm(int n, int* blocks, int device, void* stream) {
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  int packed = 0, two = 0;
  size_t dyn = 0;
  const int e = bwd_setup(n, 1 << 30, device, &packed, &dyn, &two);
  if (e != 0) return e;
  return static_cast<int>(two ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                    blocks, blocked_bwd_kernel<2>, kThreads, dyn)
                              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                    blocks, blocked_bwd_kernel<1>, kThreads, dyn));
}
