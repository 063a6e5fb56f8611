// Batched Cholesky factor L of B matrices A [B, N, N], one block per matrix,
// reading only the lower triangle of A and writing zeros above the diagonal.
// No jitter: a matrix whose pivot is not finite and positive comes back all
// NaN, and safe_cholesky escalates the jitter around the call.
//
// Replaces the Pallas TPU kernel meta_learning_pacoh_tpu/ops/pallas/
// blocked_mll_kernel.py: _chol_only_kernel (launched by _chol_only_call,
// entry blocked_cholesky).
//
// What bounds it on the card: at the evals' shape, N=200 and B=2000 (200
// test tasks x 10 particles), a matrix is 160 KB and N^3/3 = 2.7e6 flops,
// 5.3e9 for the batch: about 0.08 ms of the card's f32 rate and 0.19 ms of
// its bandwidth (bytes bound). A factorization is a chain of dependent
// steps, so the kernel is bound by one block's chain and by how many chains
// run side by side. The design (csrc/tiled_chol.cuh) cuts the chain to
// three block barriers a 32-column panel, with the trailing update from
// register micro-tiles, and packs the lower triangle so that two blocks fit
// on an SM up to N=208 (one block's barriers hide behind the other's
// arithmetic; B=2000 runs in about 8 waves of 264, not 16 of 132). The
// matrix arrives by cp.async. Above N=308 it is factored in place in the
// output in device memory (L2-resident), the scratch in shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 512;
constexpr int kThreads = 256;

#include "tiled_chol.cuh"

__global__ void __launch_bounds__(kThreads, 2)
chol_kernel(const float* __restrict__ a, float* __restrict__ out, int n, int packed) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  float* dst = out + base;
  const TiledMatrix m{packed ? smem + tiled_scratch_floats(n, n) : dst, nullptr, n, n,
                      packed != 0};
  tiled_load(m, a + base, nullptr);
  const bool ok = tiled_factor(m, 0.f, smem);
  tiled_store(m, dst, ok);
}

}  // namespace

extern "C" int pacoh_chol(const float* a, float* out, int b, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  int packed = 0;
  size_t dyn = 0;
  const int e = tiled_setup(chol_kernel, n, n, device, &packed, &dyn);
  if (e != 0) return e;
  chol_kernel<<<b, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(a, out, n, packed);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the kernel at this N, into *blocks.
extern "C" int pacoh_chol_blocks_per_sm(int n, int* blocks, int device, void* stream) {
  (void)stream;
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  return tiled_blocks_per_sm(chol_kernel, kThreads, n, n, device, blocks);
}
