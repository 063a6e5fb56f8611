// The Cholesky factorization of one small system (N <= 64) in one warp's
// registers, shared by the MLL forward K2 (mll.cu, r as the border row, a
// pivot below FLT_MIN failing as 0 does) and the small-N Cholesky B5
// (chol_small.cu, no border row, any finite positive pivot taken). Included
// inside an anonymous namespace of each kernel's source.
//
// The layout: the system arrives coalesced in a per-warp shared tile with an
// odd leading dimension (N | 1), lane l takes row l (and row l + 32 for
// N > 32, the R = 2 instance) into registers, and the right-looking
// factorization runs there: column j's pivot comes from its owner lane by
// shuffle, each lane scales its entry, and the trailing update reads the
// scaled column back from a per-warp column buffer as float4 broadcasts.
// Column j of L also goes to the tile transposed, into its upper triangle,
// so that L leaves through the tile coalesced.

// Needs <float.h> and <math.h>, included at the top of the source.

#pragma once

constexpr unsigned kFull = 0xffffffffu;
constexpr int kColBuf = 64;  // floats of a column buffer (N <= 64)

// Shared floats of one system: its N x (N | 1) tile, rounded up to 16 bytes,
// and two column buffers.
__host__ __device__ __forceinline__ int warp_floats(int n) {
  return (n * (n | 1) + 3) / 4 * 4 + 2 * kColBuf;
}

// A 4-byte copy from device memory into shared memory by cp.async, which
// lands as 0 where `take` is false (source size 0; src is then not read).
// cp_async_wait_all, then __syncwarp, before the warp reads what landed.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool take = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(take ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// 1 / sqrt(d) by the hardware's approximation, off the pivot chain's
// denormal rescaling: it flushes a pivot below FLT_MIN (2^-126) to 0.
__device__ __forceinline__ float rsqrt_approx(float d) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return r;
}

// K2's pivots: a pivot below FLT_MIN fails as 0 does (the flushing
// approximation; the GP systems carry a noise floor far above), as the JAX
// kernel's flushing arithmetic makes it.
struct NormalPivots {
  static __device__ __forceinline__ bool ok(float d) { return d >= FLT_MIN && d < INFINITY; }
  static __device__ __forceinline__ float rsqrt(float d) { return rsqrt_approx(d); }
};

// B5's pivots: every finite positive pivot, a denormal one too, as its plain
// version (torch.linalg.cholesky_ex) takes them; rsqrtf rescales a denormal
// input rather than flushing it.
struct PositivePivots {
  static __device__ __forceinline__ bool ok(float d) { return d > 0.f && d < INFINITY; }
  static __device__ __forceinline__ float rsqrt(float d) { return rsqrtf(d); }
};

// The factorization of one system in one warp's registers. a[s][k] is row
// lane + 32 s, column j0 + k: a window that slides U columns at the end of
// each pass of the column loop, so the arrays are indexed only by unrolled
// loop indices while the loop over the columns stays a loop, whose body
// stays in the instruction cache (fully unrolled, the columns streamed as
// code once a system). Column j's entries below the pivot go through a
// per-warp column buffer in shared memory (two, alternating, so one
// __syncwarp a column orders them): every lane reads them back as float4
// broadcasts. The trailing update runs in groups of G columns (8; 4 for
// N > 32, which keeps that instance's registers from spilling), and in
// spans of Span columns (a multiple of G) under one uniform guard a span:
// with Span = G every group's float4 load waits behind its own branch, so
// the loads of a column queue one after another; with a wider span they all
// issue before the span's FMAs (the columns of a span beyond N take values
// that are never read: the column buffer holds 64 floats, rows and columns
// beyond N are never pivots, never stored). Each row also updates its own next diagonal entry
// from its own L entry (dn: the value the group update gives it, bit for
// bit), so the next pivot's shuffle does not wait on the column buffer.
// Entries above the diagonal carry values that are never read. With
// `Border`, w[s] is the row's entry of the border row r, carried through
// the same updates so that z = L^-1 r falls out as the columns complete.
// Column j of L also goes to the tile transposed, into its upper triangle
// (L[row][j] at tile[j][row]), which a reload of the lower triangle does not
// read. Returns whether every pivot passed Pivots::ok; unless `last`, it
// stops at the first that does not. On return w[s] holds z (with `Border`)
// and dg[s] the diagonal of the rows.
template <int R, bool Border, class Pivots, int Span = 8 / R>
__device__ __forceinline__ bool factor_rows(float (&a)[R][32 * R], float (&w)[R], float (&dg)[R],
                                            float* tile, float* colbuf, int ld, int n, int lane,
                                            bool last) {
  constexpr int U = 4;
  constexpr int G = 8 / R;
  static_assert(Span % G == 0 && (32 * R) % Span == 0, "a span is whole groups");
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
        if (!last && !Pivots::ok(d)) return false;
        const float inv = Pivots::rsqrt(d);
        float zj = 0.f;
        if constexpr (Border) zj = __shfl_sync(kFull, wide ? w[R - 1] : w[0], j & 31) * inv;
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
          if constexpr (Border) w[s] = row == j ? zj : (row > j ? w[s] - l * zj : w[s]);
          lj[s] = l;
          dn[s] = a[s][u + 1] - l * l;
        }
        __syncwarp();
#pragma unroll
        for (int c1 = 0; c1 < 32 * R; c1 += Span) {
          if (j + (c1 > 0 ? c1 : 1) < n) {  // the span's first column is in the matrix
            float lc[Span];
#pragma unroll
            for (int v = 0; v < Span / 4; ++v) {
              const float4 q = reinterpret_cast<const float4*>(col)[c1 / 4 + v];
              lc[4 * v] = q.x;
              lc[4 * v + 1] = q.y;
              lc[4 * v + 2] = q.z;
              lc[4 * v + 3] = q.w;
            }
#pragma unroll
            for (int c0 = c1; c0 < c1 + Span; c0 += G) {
#pragma unroll
              for (int e = 0; e < G; ++e) {
#pragma unroll
                for (int s = 0; s < R; ++s)
                  if (c0 + e > 0 && u + c0 + e < 32 * (s + 1) && (s > 0 || j < 32))
                    a[s][u + c0 + e] -= lj[s] * lc[c0 - c1 + e];
              }
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
