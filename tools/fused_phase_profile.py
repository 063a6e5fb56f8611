#!/usr/bin/env python3
"""Profile the phases of the fused SVGD (B2) and VI (B7) kernels, of the big-N
ones (B10, B11), or of the PACOH-MAP ones (B6, B9), by ``clock64()`` marks, on
one CUDA card.

    python3 tools/fused_phase_profile.py [--root DIR] [--work DIR] [--out FILE]
    python3 tools/fused_phase_profile.py --bign [--root DIR] [--work DIR] [--out FILE]
    python3 tools/fused_phase_profile.py --map [--root DIR] [--work DIR] [--out FILE]
    python3 tools/fused_phase_profile.py --mlap [--root DIR] [--work DIR] [--out FILE]

Copies ``meta_learning_pacoh_torch`` of the checkout ``--root`` (default:
this one) into ``--work`` (default ``_scratch_tree/phase_profile``, which
git ignores; never the package itself), adds marks to the copy's B2 and B7
sources and builds it: thread 0 of block 0 adds the cycles since its last
mark to a per-phase counter at each mark, each mark placed after a barrier
so that it closes the block's phase. Then it runs 200 steps of each kernel
in one launch at ``sin_20``'s shapes (K = S = 10, NN/NN 32x32) and prints the
cycles a step of every phase, the profiled build's time a step, and the
card's name, power limit and SM clock. It knows two layouts of the kernels:
one block a particle or sample (score_section.cuh) and one cluster a
particle or sample (cluster_score.cuh). The marks add a few barriers and
global stores, so the times are the profiled build's, not the kernel's.

``--bign`` marks B10 and B11 instead (one block a system, bign_score.cuh;
two layouts: the column-at-a-time algebra of blocked_factor.cuh, and the
tiled panels of tiled_chol.cuh and tiled_inverse.cuh) and runs 100 steps of
each at ``svgd_t5_n200`` / ``vi_t5_n200`` (K = S = 10, 5 tasks of N=200,
NN/NN 32x32, from the learners' initial states) and B10 at ``cauchy_20``'s
shapes (N=20, 200 systems, two a block) and at the faceoff's N=9 corner (5
tasks).

``--map`` marks B9 and B6 instead (each tree's layout: B9 one block a task
group on blocked_factor.cuh's columns, or one block a task on the tiled
panels; B6 one cooperative grid of blocks, or one thread-block cluster) and
runs 100 steps of B9 at ``map_t5_n200`` (5 tasks of N=200, F=2, NN/NN
32x32, full batch) and 200 of B6 at the MAP demo's shapes (20 tasks of 5
points, F=2), counted (task batch 5, the learner's count pages) and full
batch, from the learners' initial states.

``--mlap`` marks the fused PACOH-MLAP kernel B8 instead (each tree's layout:
one block a sample, or one thread-block cluster a sample) and runs 200
steps at bench.py's ``mlap`` shapes (S=5, 20 tasks of 5 points, NN/NN
32x32, from the learner's initial state and its own pages), counted (the
learner's count pages) and full batch, and 200 meta-test steps at T=5 and
T=20 (the same phases without the backward).
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = 200
BIGN_STEPS = 100
N_MARKS = 24

PROF = """
__device__ long long g_prof[24];
__device__ long long g_t0;
__device__ __forceinline__ void prof_mark(int i) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const long long t = clock64();
    g_prof[i] += t - g_t0;
    g_t0 = t;
  }
}
"""

READER = """
extern "C" int pacoh_prof_read_%s(long long* out) {
  long long zero[24] = {0};
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(zero));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
}
"""

# (file, anchor, text inserted after the anchor); each anchor occurs once
ONE_BLOCK = {
    "header": "score_section.cuh",
    "patches": [
        ("score_section.cuh", "  nets_forward(th, o, M, D, H, L, w);\n", "  prof_mark(1);\n"),
        ("score_section.cuh", "  __syncthreads();\n\n  // ---- backward of both nets into the score\n",
         "  prof_mark(2);\n"),
        ("score_section.cuh", "    if (kValue) *wql_out = sq;\n  }\n  __syncthreads();\n",
         "  prof_mark(3);\n"),
        ("fused_svgd.cu", "    const int par = it & 1;\n", "    prof_mark(0);\n"),
        ("fused_svgd.cu", "      s_pub[c] = s;\n    }\n", "    __syncthreads();\n    prof_mark(4);\n"),
        ("fused_svgd.cu", "      s_pub[c] = s;\n    }\n    __syncthreads();\n    prof_mark(4);\n"
         "    grid.sync();\n", "    prof_mark(5);\n"),
        ("fused_svgd.cu", "      if (lane == 0) q.d2[me * K + j] = acc;\n    }\n",
         "    __syncthreads();\n    prof_mark(6);\n"),
        ("fused_svgd.cu", "    prof_mark(6);\n    grid.sync();\n", "    prof_mark(7);\n"),
        ("fused_svgd.cu", "    const float gamma = rbf_gamma(median_upper(d2s, kk, scal), q.log_kp1);\n",
         "    prof_mark(8);\n"),
        ("fused_svgd.cu", "          v_me[c], q.lr, bc1, bc2);\n    }\n    __syncthreads();\n",
         "    prof_mark(9);\n"),
        ("fused_vi.cu", "    const int par = it & 1;\n", "    prof_mark(0);\n"),
        ("fused_vi.cu", "* __ldg(eps_me + c);\n    __syncthreads();\n", "    prof_mark(10);\n"),
        ("fused_vi.cu", "(-0.5f * (scal[0] + q.mll_const));\n    }\n",
         "    __syncthreads();\n    prof_mark(4);\n"),
        ("fused_vi.cu", "    prof_mark(4);\n    grid.sync();\n", "    prof_mark(5);\n"),
        ("fused_vi.cu", "      adam(g_lsc, lsc[c], mls[c], vls[c], q.lr, bc1, bc2);\n    }\n",
         "    __syncthreads();\n    prof_mark(8);\n"),
        ("fused_vi.cu", "        loss_sum += loss;\n      }\n    }\n    __syncthreads();\n",
         "    prof_mark(9);\n"),
    ],
    "svgd": {0: "loop", 1: "both nets forward", 2: "per-task MLL", 3: "both nets backward",
             4: "hyper-prior term, publish", 5: "grid barrier 1", 6: "distances",
             7: "grid barrier 2", 8: "median", 9: "transport, Adam"},
    "vi": {0: "loop", 10: "sample", 1: "both nets forward", 2: "per-task MLL",
           3: "both nets backward", 4: "hyper-prior term, publish, objective",
           5: "grid barrier", 8: "reduction over S, Adam", 9: "loss (block 0)"},
}

CLUSTER = {
    "header": "cluster_score.cuh",
    "patches": [
        ("cluster_score.cuh", "  cluster_forward(th, o, D, H, L, w);\n", "  prof_mark(1);\n"),
        ("cluster_score.cuh", "  cluster_tasks<N, kValue>(th, o, L, w_t, counts, w);\n",
         "  prof_mark(2);\n"),
        ("cluster_score.cuh", "  cluster_backward<kValue>(th, sc, o, D, H, L, w, wql_out);\n",
         "  __syncthreads();\n  prof_mark(3);\n"),
        ("fused_svgd.cu", "    const int par = it & 1;\n", "    prof_mark(0);\n"),
        ("fused_svgd.cu", "                         w, nullptr);\n    cluster.sync();\n",
         "    prof_mark(4);\n"),
        ("fused_svgd.cu", "(scale * scale));\n    }\n", "    __syncthreads();\n    prof_mark(5);\n"),
        ("fused_svgd.cu", "    prof_mark(5);\n    grid.sync();\n", "    prof_mark(6);\n"),
        ("fused_svgd.cu", "xst + cc, sst + cc, PT);\n      }\n      __syncthreads();\n",
         "      prof_mark(13);\n"),
        ("fused_svgd.cu", "        pd2[pr] = acc;\n      }\n      __syncthreads();\n    }\n",
         "    prof_mark(7);\n"),
        ("fused_svgd.cu", "    prof_mark(7);\n    cluster.sync();\n", "    prof_mark(8);\n"),
        ("fused_svgd.cu", "      kw[tid] = expf(-gamma * dd);\n    }\n    if (vec) cp_async_wait<0>();\n"
         "    __syncthreads();\n",
         "    prof_mark(9);\n"),
        ("fused_svgd.cu", "m_me[c], v_me[c], q.lr, bc1, bc2);\n      }\n    }\n",
         "    __syncthreads();\n    prof_mark(10);\n"),
        ("fused_svgd.cu", "then the particle whole again\n    cluster.sync();\n", "    prof_mark(11);\n"),
        ("fused_svgd.cu", "      cluster_gather(cluster, th, P);\n      __syncthreads();\n    }\n",
         "    prof_mark(12);\n"),
        ("fused_vi.cu", "    const int par = it & 1;\n", "    prof_mark(0);\n"),
        ("fused_vi.cu", "    if (it > 0) step_loss((it - 1) & 1);\n", "    prof_mark(11);\n"),
        ("fused_vi.cu", "    prof_mark(11);\n    cluster.sync();\n", "    prof_mark(4);\n"),
        ("fused_vi.cu", "      o_pub[1] = scal[0];\n    }\n", "    __syncthreads();\n    prof_mark(5);\n"),
        ("fused_vi.cu", "    prof_mark(5);\n    grid.sync();\n", "    prof_mark(6);\n"),
        ("fused_vi.cu", "__ldg(eps_next + c);\n    }\n", "    __syncthreads();\n    prof_mark(10);\n"),
        ("fused_vi.cu", "    lsum = block_sum(lsum, red);\n", "    prof_mark(7);\n"),
        ("fused_vi.cu", "    if (tid == 0) scal[1] = lsum;\n    cluster.sync();\n", "    prof_mark(9);\n"),
        ("fused_vi.cu", "    if (more) cluster_gather(cluster, th, P);\n    __syncthreads();\n",
         "    prof_mark(8);\n"),
    ],
    "svgd": {0: "loop", 1: "both nets forward", 2: "per-task MLL", 3: "both nets backward",
             4: "cluster barrier A", 5: "cluster sum of the slice, hyper-prior term, publish",
             6: "grid barrier", 13: "staging the slice", 7: "distances of the slice",
             8: "cluster barrier B",
             9: "cluster sum of the distances, median, kernel row", 10: "transport, Adam",
             11: "cluster barrier C", 12: "gather"},
    "vi": {0: "loop", 1: "both nets forward", 2: "per-task MLL", 3: "both nets backward",
           11: "the previous step's loss (its CTA only)", 4: "cluster barrier A",
           5: "cluster sum of the slice, hyper-prior term, publish", 6: "grid barrier",
           10: "reduction over S, Adam, next sample", 7: "sum of log_scale",
           9: "cluster barrier B", 8: "gather"},
}


# the big-N kernels' step, shared by both layouts of their system
BIGN_STEP = [
    ("fused_svgd_bign.cu", "    const int par = it & 1;\n", "    prof_mark(0);\n"),
    ("fused_svgd_bign.cu", "    // ---- the block's systems, in order: minus their partial gradients\n",
     "    __syncthreads();\n    prof_mark(14);\n"),
    ("fused_svgd_bign.cu", "    grid.sync();\n\n    // ---- every block: the median (rank K*K/2) and the "
     "K x K kernel matrix\n", "    prof_mark(13);\n"),
    ("fused_svgd_bign.cu", "      rsum[tid] = s;\n    }\n    __syncthreads();\n", "    prof_mark(15);\n"),
    ("fused_svgd_bign.cu", "    grid.sync();\n  }\n\n  // the block's own coordinates of the last step\n",
     "    __syncthreads();\n    prof_mark(16);\n    grid.sync();\n    prof_mark(17);\n  }\n\n"
     "  // the block's own coordinates of the last step\n", "replace"),
    ("fused_vi_bign.cu", "    const float* eps_it = q.eps + static_cast<size_t>(it) * S * P;\n",
     "    prof_mark(0);\n"),
    ("fused_vi_bign.cu", "    }\n    grid.sync();\n\n    // ---- a share of the P coordinates",
     "    }\n    __syncthreads();\n    prof_mark(14);\n    grid.sync();\n    prof_mark(13);\n\n"
     "    // ---- a share of the P coordinates", "replace"),
    ("fused_vi_bign.cu", "      loss_sum += loss;\n    }\n    grid.sync();\n  }\n",
     "      loss_sum += loss;\n    }\n    __syncthreads();\n    prof_mark(16);\n    grid.sync();\n"
     "    prof_mark(17);\n  }\n", "replace"),
    ("bign_score.cuh", "  const int off_ls = o[4 * L + 4], off_nz = o[4 * L + 5];\n",
     "  prof_mark(1);\n"),
]
BIGN_SVGD = {0: "loop", 14: "distances", 1: "load the system", 2: "both nets forward",
             3: "matrix and factor, level 0", 4: "matrix and factor, level 1",
             5: "matrix and factor, level 2", 6: "forward_subst", 7: "logdet (and quad)",
             18: "inverse: diagonal tiles", 19: "inverse: Y = L21 W11",
             20: "inverse: W21 = -W22 Y", 8: "inverse W = L^-1 (the rest)",
             9: "alpha = W^T z", 10: "K^-1 = W^T W",
             11: "score loop", 12: "both nets backward", 13: "grid barrier 1",
             15: "median, kernel matrix", 16: "transport, Adam", 17: "grid barrier 2"}
BIGN_VI = {**{i: v for i, v in BIGN_SVGD.items() if i not in (14, 15, 16)},
           14: "prior quad, sum of log_scale", 16: "reduction over S, Adam, loss"}

# one block a system, the column-at-a-time algebra of blocked_factor.cuh
BIGN_COLUMN = {
    "header": "bign_score.cuh (blocked_factor.cuh)",
    "patches": BIGN_STEP + [
        ("bign_score.cuh", "  net_forward(th, o_k, wd + L, L, 1, k.xs, D, N, N, k.act_k, k.outk);\n"
         "  __syncthreads();\n", "  prof_mark(2);\n"),
        ("bign_score.cuh", "  net_backward(th, o_k, wd + L, L, 1, k.xs, D, N, N, k.act_k, k.outk, gb);\n",
         "  __syncthreads();\n  prof_mark(12);\n"),
        ("blocked_factor.cuh", "    if (factor_lower(m, n, ld, pcol)) return level;\n",
         "    const bool done = factor_lower(m, n, ld, pcol);\n    prof_mark(3 + level);\n"
         "    if (done) return level;\n", "replace"),
        ("bign_score.cuh", "  const float quad = forward_subst(mat, N, ld, k.rv, k.zv, k.red);\n",
         "  prof_mark(6);\n"),
        ("bign_score.cuh", "  const float ql = quad + logdet_lower(mat, N, ld, k.red);\n",
         "  prof_mark(7);\n"),
        ("bign_score.cuh", "  invert_lower(mat, N, ld, k.pcol);\n", "  prof_mark(8);\n"),
        ("bign_score.cuh", "  wt_times(mat, N, ld, k.zv, k.al);\n", "  prof_mark(9);\n"),
        ("bign_score.cuh", "  for (int i = tid; i < N; i += nth) ph[i] = k.rowp[3 * i] / sp_ls;\n",
         "  prof_mark(11);\n", "before"),
    ],
    "svgd_bign": BIGN_SVGD,
    "vi_bign": BIGN_VI,
}


# one block a system, the tiled panels of tiled_chol.cuh and tiled_inverse.cuh
BIGN_TILED = {
    "header": "bign_score.cuh (tiled_chol.cuh, tiled_inverse.cuh)",
    "patches": BIGN_STEP + [
        ("bign_score.cuh", "  bign_net_forward(th, o_k, L, H, D, k.xs, N, k.act_k, k.outk);\n"
         "  __syncthreads();\n", "  prof_mark(2);\n"),
        ("bign_score.cuh", "  bign_net_backward(th, o_k, L, H, D, k.xs, N, k.act_k, k.outk, gb);\n",
         "  prof_mark(12);\n"),
        ("bign_score.cuh", "    ok = tiled_factor(M, 0.f, k.tws);\n", "    prof_mark(3 + level);\n"),
        ("tiled_inverse.cuh", "                tile_log + t);\n  __syncthreads();\n",
         "  prof_mark(18);\n"),
        ("tiled_inverse.cuh", "y[4 * q + 3]);\n    }\n    __syncthreads();\n", "    prof_mark(19);\n"),
        ("tiled_inverse.cuh", "-acc[u][2], -acc[u][3]));\n      }\n    }\n    __syncthreads();\n",
         "    prof_mark(20);\n"),
        ("bign_score.cuh", "  tiled_invert(M, k.tws, k.sums);\n", "  prof_mark(8);\n"),
        ("bign_score.cuh", "  tiled_wt_times(M, z, k.al);\n", "  prof_mark(9);\n"),
        ("bign_score.cuh", "  tiled_lauum(M);\n", "  prof_mark(10);\n"),
        ("bign_score.cuh", "  for (int i = tid; i < N; i += nth) ph[i] = k.rowp[3 * i] / sp_ls;\n",
         "  prof_mark(11);\n", "before"),
    ],
    "svgd_bign": BIGN_SVGD,
    "vi_bign": BIGN_VI,
}


# PACOH-MAP, the parents' layouts: B9 one block a task group on the column
# chains of blocked_factor.cuh, B6 a cooperative grid of blocks
MAP_GRID_STEP = [
    ("fused_map.cu", "    float* gb = q.gbuf + static_cast<size_t>(blk) * (P + 1);\n",
     "    prof_mark(0);\n", "before"),
    ("fused_map.cu", "    const float diag_add = softplus(th[off_nz]) + q.noise_floor + 1e-6f;\n",
     "    prof_mark(1);\n", "before"),
    ("fused_map.cu", "    // both nets' backward, and the hyperparameters' gradients\n",
     "    prof_mark(2);\n", "before"),
    ("fused_map.cu", "    grid.sync();\n\n    // reduce my coordinates",
     "    __syncthreads();\n    prof_mark(10);\n    grid.sync();\n    prof_mark(11);\n\n"
     "    // reduce my coordinates", "replace"),
    ("fused_map.cu", "    if (it + 1 < q.n_steps) {\n      grid.sync();\n",
     "    __syncthreads();\n    prof_mark(12);\n    if (it + 1 < q.n_steps) {\n      grid.sync();\n"
     "      prof_mark(13);\n", "replace"),
    ("fused_map.cu", "      for (int c = tid; c < P; c += nth) th[c] = __ldcg(q.theta + c);\n"
     "      __syncthreads();\n", "      prof_mark(14);\n"),
]
MAP_BIGN_COLUMN_STEP = [
    ("fused_map_bign.cu", "    float* gb = q.gbuf + static_cast<size_t>(blk) * (P + 1);\n",
     "    prof_mark(0);\n", "before"),
    ("fused_map_bign.cu", "    if (tid < F + 3) hyp[tid] = 0.f;\n    __syncthreads();\n",
     "    prof_mark(1);\n"),
    ("fused_map_bign.cu", "  for (int i = tid; i < N; i += nth) rv[i] = (y[i] - mu[i]) * msk[i];\n"
     "  __syncthreads();\n", "  prof_mark(2);\n"),
    ("fused_map_bign.cu", "  const float quad = forward_subst(", "  prof_mark(3);\n", "before"),
    ("fused_map_bign.cu", "  const float logdet = logdet_lower(mat, N, ld, red);\n",
     "  prof_mark(4);\n", "before"),
    ("fused_map_bign.cu", "  invert_lower(mat, N, ld, pcol);\n", "  prof_mark(5);\n", "before"),
    ("fused_map_bign.cu", "  wt_times(mat, N, ld, zv, al);\n", "  prof_mark(6);\n", "before"),
    ("fused_map_bign.cu", "  for (int i = tid; i < N; i += nth) mu[i] = w * al[i] * msk[i];\n",
     "  prof_mark(7);\n", "before"),
    ("fused_map_bign.cu", "  for (int e = tid; e < N * F; e += nth) ph[e] = rowp[",
     "  prof_mark(8);\n", "before"),
    ("fused_map_bign.cu", "    // both nets' backward, and the hyperparameters' gradients\n",
     "    prof_mark(9);\n", "before"),
    ("fused_map_bign.cu", "    grid.sync();\n\n    // reduce my coordinates",
     "    __syncthreads();\n    prof_mark(10);\n    grid.sync();\n    prof_mark(11);\n\n"
     "    // reduce my coordinates", "replace"),
    ("fused_map_bign.cu", "    if (it + 1 < q.n_steps) {\n      grid.sync();\n",
     "    __syncthreads();\n    prof_mark(12);\n    if (it + 1 < q.n_steps) {\n      grid.sync();\n"
     "      prof_mark(13);\n", "replace"),
    ("fused_map_bign.cu", "      for (int c = tid; c < P; c += nth) th[c] = __ldcg(q.theta + c);\n"
     "      __syncthreads();\n", "      prof_mark(14);\n"),
]
MAP_GRID_NAMES = {0: "loop", 1: "both nets forward", 2: "per-task MLL (a thread a task)",
                  10: "both nets backward, hyperparameters", 11: "grid barrier 1",
                  12: "AdamW split", 13: "grid barrier 2", 14: "theta re-read"}
MAP_BIGN_COLUMN_NAMES = {0: "loop", 1: "both nets forward", 2: "z, residual",
                         3: "matrix and factor (escalation)", 4: "forward_subst",
                         5: "logdet, loss term", 6: "inverse W = L^-1", 7: "alpha = W^T z",
                         8: "score loop (kinv_entry)", 9: "the task's sums",
                         10: "both nets backward, hyperparameters", 11: "grid barrier 1",
                         12: "AdamW split", 13: "grid barrier 2", 14: "theta re-read"}
# PACOH-MAP, the redesign's layouts: B9 one block a task on the tiled
# panels, B6 one thread-block cluster
MAP_TILED_BIGN_STEP = [
    ("fused_map_bign.cu", "  for (int it = 0; it < q.n_steps; ++it) {\n", "    prof_mark(0);\n"),
    ("fused_map_bign.cu", "      if (q.tiled) {\n        tile_nets_forward(th, nets, xs, D, N, ld);\n",
     "      prof_mark(1);\n", "before"),
    ("fused_map_bign.cu", "      map_task_grad(N, F, sp_os, diag_add, w, k);\n", "      prof_mark(2);\n",
     "before"),
    ("fused_map_bign.cu", "  // the bordered system at the first jitter level that factors, a warp a row\n",
     "  prof_mark(3);\n", "before"),
    ("fused_map_bign.cu", "    ok = tiled_factor(M, 0.f, k.tws);\n", "    prof_mark(4 + level);\n"),
    ("fused_map_bign.cu", "  tiled_invert(M, k.tws, k.sums);\n", "  prof_mark(7);\n"),
    ("fused_map_bign.cu", "  tiled_wt_times(M, z, k.al);\n", "  prof_mark(8);\n"),
    ("fused_map_bign.cu", "  tiled_lauum(M);\n", "  prof_mark(9);\n"),
    ("fused_map_bign.cu", "  for (int e = tid; e < N * F; e += nth) ph[e] = rowp[",
     "  prof_mark(10);\n", "before"),
    ("fused_map_bign.cu", "      if (q.tiled) {\n        tile_nets_backward(th, nets, xs", "      prof_mark(11);\n",
     "before"),
    ("fused_map_bign.cu", "      if (gb != gsum) {\n", "      prof_mark(12);\n", "before"),
    ("fused_map_bign.cu", "    grid.sync();\n\n    // reduce my coordinates over the G partials",
     "    __syncthreads();\n    prof_mark(13);\n    grid.sync();\n    prof_mark(14);\n\n"
     "    // reduce my coordinates over the G partials", "replace"),
    ("fused_map_bign.cu", "    if (it + 1 < q.n_steps) {\n      grid.sync();\n",
     "    __syncthreads();\n    prof_mark(15);\n    if (it + 1 < q.n_steps) {\n      grid.sync();\n"
     "      prof_mark(16);\n", "replace"),
    ("fused_map_bign.cu", "      for (int c = tid; c < P; c += nth) th[c] = __ldcg(q.theta + c);\n"
     "      __syncthreads();\n", "      prof_mark(17);\n"),
    ("tiled_inverse.cuh", "                tile_log + t);\n  __syncthreads();\n", "  prof_mark(18);\n"),
    ("tiled_inverse.cuh", "y[4 * q + 3]);\n    }\n    __syncthreads();\n", "    prof_mark(19);\n"),
    ("tiled_inverse.cuh", "-acc[u][2], -acc[u][3]));\n      }\n    }\n    __syncthreads();\n",
     "    prof_mark(20);\n"),
]
MAP_CLUSTER_STEP = [
    ("fused_map.cu", "    // the step's drawn tasks of the CTA, in order (warp 0, 32 tasks a round)\n",
     "    prof_mark(0);\n", "before"),
    ("fused_map.cu", "    const float* xr = all ? xs : xa;\n", "    prof_mark(1);\n", "before"),
    ("fused_map.cu", "    // per-task loss and gradient, task a on thread (a mod 32) * warps + a / 32\n",
     "    prof_mark(2);\n", "before"),
    ("fused_map.cu", "    // both nets' backward, and the hyperparameters' gradients and the loss\n",
     "    prof_mark(3);\n", "before"),
    ("fused_map.cu", "        sc[P] = s;\n      }\n    }\n    cluster.sync();\n",
     "        sc[P] = s;\n      }\n    }\n    __syncthreads();\n    prof_mark(4);\n"
     "    cluster.sync();\n    prof_mark(5);\n", "replace"),
    ("fused_map.cu", "    // every slice is updated and in every copy (and no CTA reads another's\n",
     "    __syncthreads();\n    prof_mark(6);\n", "before"),
    ("fused_map.cu", "    // shared memory any more, so none may exit early)\n    cluster.sync();\n",
     "    prof_mark(7);\n"),
]
MAP_CLUSTER_NAMES = {0: "loop", 1: "drawn tasks, compaction", 2: "both nets forward",
                     3: "per-task MLL (a thread a task)", 4: "both nets backward, hyperparameters",
                     5: "cluster barrier A",
                     6: "rank-order sums of the slice, AdamW, its stores to every CTA, loss",
                     7: "cluster barrier B"}
MAP_TILED_BIGN_NAMES = {0: "loop", 1: "load the task", 2: "both nets forward", 3: "z, residual",
                        4: "matrix and factor, level 0", 5: "matrix and factor, level 1",
                        6: "matrix and factor, level 2", 18: "inverse: diagonal tiles",
                        19: "inverse: Y = L21 W11", 20: "inverse: W21 = -W22 Y",
                        7: "inverse W = L^-1 (the rest)", 8: "alpha = W^T z",
                        9: "K^-1 = W^T W, |z|^2, n_eff", 10: "score loop",
                        11: "the task's sums, loss", 12: "both nets backward, hyperparameters",
                        13: "block sums", 14: "grid barrier 1", 15: "AdamW split",
                        16: "grid barrier 2", 17: "theta re-read"}
MAP_TILED = {"header": "fused_map.cu (cluster), fused_map_bign.cu (tiled_chol.cuh, tiled_inverse.cuh)",
             "patches": MAP_CLUSTER_STEP + MAP_TILED_BIGN_STEP,
             "map": MAP_CLUSTER_NAMES, "map_bign": MAP_TILED_BIGN_NAMES}
MAP_PARENT = {"header": "fused_map.cu (grid), fused_map_bign.cu (blocked_factor.cuh)",
              "patches": MAP_GRID_STEP + MAP_BIGN_COLUMN_STEP,
              "map": MAP_GRID_NAMES, "map_bign": MAP_BIGN_COLUMN_NAMES}


# PACOH-MLAP (B8): the parent's layout, one block a sample on the one-block
# passes of score_section.cuh, two grid barriers a step (one in meta-test mode)
MLAP_NAMES = {0: "loop", 1: "outer KL, sample", 2: "both nets forward", 3: "per-task KL",
              4: "grid barrier 1", 5: "bound, gamma, loss", 6: "both nets backward",
              7: "publish the score", 8: "grid barrier 2",
              9: "reduction over S, Adam (meta-test: the q side only)"}
MLAP_ONE_BLOCK = {
    "header": "fused_mlap.cu (one block a sample)",
    "patches": [
        ("fused_mlap.cu", "    const int par = it & 1;\n", "    prof_mark(0);\n"),
        ("fused_mlap.cu", "2.f * q.sum_log_sigma_p - 2.f * a_ls));\n", "    prof_mark(1);\n"),
        ("fused_mlap.cu", "    nets_forward(th, q.offs, M, D, H, L, ws);\n", "    prof_mark(2);\n"),
        ("fused_mlap.cu", "      kl_pub[t] = kl;\n    }\n", "    __syncthreads();\n    prof_mark(3);\n"),
        ("fused_mlap.cu", "    grid.sync();\n\n    // ---- every block: the bound",
         "    grid.sync();\n    prof_mark(4);\n\n    // ---- every block: the bound", "replace"),
        ("fused_mlap.cu", "    __syncthreads();\n\n    const float t_f",
         "    __syncthreads();\n    prof_mark(5);\n\n    const float t_f", "replace"),
        ("fused_mlap.cu", "        sc[off_nz] = 0.f;\n      }\n      __syncthreads();\n",
         "      prof_mark(6);\n"),
        ("fused_mlap.cu", "      for (int c = tid; c < P; c += nth) s_pub[c] = sc[c];\n",
         "      __syncthreads();\n      prof_mark(7);\n"),
        ("fused_mlap.cu", "      grid.sync();\n\n      // ---- every block: the hyper-posterior's",
         "      grid.sync();\n      prof_mark(8);\n\n      // ---- every block: the hyper-posterior's",
         "replace"),
        ("fused_mlap.cu", "      adam(g, qt[e], mqt[e], vqt[e], q.lr_post, bc1, bc2);\n    }\n"
         "    __syncthreads();\n", "    prof_mark(9);\n"),
    ],
    "mlap": MLAP_NAMES,
}
# one thread-block cluster a sample (cluster_score.cuh's passes), B7's layout
MLAP_CLUSTER = {
    "header": "fused_mlap.cu (one cluster a sample)",
    "patches": [
        ("fused_mlap.cu", "    const int par = it & 1;\n", "    prof_mark(0);\n"),
        ("fused_mlap.cu", "    cluster_forward(th, o, D, H, L, w);\n", "    prof_mark(1);\n"),
        ("fused_mlap.cu", "      kl_pub[3 * t + 2] = dvr;\n    }\n",
         "    __syncthreads();\n    prof_mark(3);\n"),
        ("fused_mlap.cu", "    grid.sync();\n\n    // ---- every CTA: every task's bound",
         "    grid.sync();\n    prof_mark(4);\n\n    // ---- every CTA: every task's bound", "replace"),
        ("fused_mlap.cu", "    block_sums<5>(v, red);\n", "    prof_mark(5);\n"),
        ("fused_mlap.cu", "      cluster_backward<false>(th, sc, o, D, H, L, w, nullptr);\n",
         "      __syncthreads();\n      prof_mark(6);\n"),
        ("fused_mlap.cu", "      cluster.sync();\n      float* s_pub",
         "      cluster.sync();\n      prof_mark(10);\n      float* s_pub", "replace"),
        ("fused_mlap.cu", "s_pub[c] = cluster_sum(cluster, sc, c);\n",
         "      __syncthreads();\n      prof_mark(7);\n"),
        ("fused_mlap.cu", "      grid.sync();\n\n      // ---- every cluster: the gradients",
         "      grid.sync();\n      prof_mark(8);\n\n      // ---- every cluster: the gradients",
         "replace"),
        ("fused_mlap.cu", "scal[9], scal[10], q.lr_main, bc1, bc2);\n      }\n",
         "      __syncthreads();\n      prof_mark(9);\n"),
        ("fused_mlap.cu", "        adam(g, qt[e], mqt[e], vqt[e], q.lr_post, bc1, bc2);\n      }\n"
         "    }\n", "    __syncthreads();\n    prof_mark(11);\n"),
        ("fused_mlap.cu", "      if (train) outer_kl(cluster, scal, q);\n    }\n"
         "    __syncthreads();\n", "    prof_mark(12);\n"),
    ],
    "mlap": {0: "loop", 1: "both nets forward", 3: "per-task KL", 4: "grid barrier 1",
             5: "bound, gamma, loss", 6: "both nets backward", 10: "cluster barrier A",
             7: "cluster sum of the slice, publish", 8: "grid barrier 2",
             9: "reduction over S, Adam of the slice (meta-test: the next sample)",
             11: "reduction over S, Adam of the tasks' posteriors",
             12: "cluster barrier B, gather, outer KL"},
}

# the kernel in fused_mlap.cuh, untiled in fused_mlap.cu (the one profiled),
# tiled in fused_mlap_tiled.cu; the passes a tile at a time
MLAP_SPLIT = {
    "header": "fused_mlap.cuh (one cluster a sample, tiles of tasks)",
    "patches": [("fused_mlap.cuh", *patch_) for patch_ in [
        ("    const int par = it & 1;\n", "    prof_mark(0);\n"),
        ("      cluster_forward(th, o, D, H, L, wt);\n      const float sp_ls",
         "      cluster_forward(th, o, D, H, L, wt);\n      prof_mark(1);\n      const float sp_ls",
         "replace"),
        ("          cotl[im] = pls[i];\n        }\n      }\n    }\n",
         "    __syncthreads();\n    prof_mark(3);\n"),
        ("    grid.sync();\n\n    // ---- every CTA: every task's bound",
         "    grid.sync();\n    prof_mark(4);\n\n    // ---- every CTA: every task's bound", "replace"),
        ("    block_sums<5>(v, red);\n", "    prof_mark(5);\n"),
        ("        cluster_backward<false>(th, sc, o, D, H, L, wt, nullptr, j == 0, j == nj - 1);\n"
         "      }\n", "      __syncthreads();\n      prof_mark(6);\n"),
        ("      cluster.sync();\n      float* s_pub",
         "      cluster.sync();\n      prof_mark(10);\n      float* s_pub", "replace"),
        ("s_pub[c] = cluster_sum(cluster, sc, c);\n", "      __syncthreads();\n      prof_mark(7);\n"),
        ("      grid.sync();\n\n      // ---- every cluster: the gradients",
         "      grid.sync();\n      prof_mark(8);\n\n      // ---- every cluster: the gradients",
         "replace"),
        ("scal[9], scal[10], q.lr_main, bc1, bc2);\n      }\n",
         "      __syncthreads();\n      prof_mark(9);\n"),
        ("        adam(g, qt[e], mqt[e], vqt[e], q.lr_post, bc1, bc2);\n      }\n    }\n",
         "    __syncthreads();\n    prof_mark(11);\n"),
        ("      if (train) outer_kl(cluster, scal, q);\n    }\n    __syncthreads();\n",
         "    prof_mark(12);\n"),
    ]],
    "mlap": MLAP_CLUSTER["mlap"],
}


def map_layout(csrc):
    """The layout of a tree's B6 and B9 sources."""
    with open(os.path.join(csrc, "fused_map_bign.cu")) as f:
        if "#include \"blocked_factor.cuh\"" in f.read():
            return MAP_PARENT
    return MAP_TILED


def patch(body, anchor, text, how="after"):
    if body.count(anchor) != 1:
        raise RuntimeError(f"fused_phase_profile: anchor found {body.count(anchor)} times: "
                           f"{anchor!r}")
    return body.replace(anchor, {"after": anchor + text, "before": text + anchor,
                                 "replace": text}[how])


def patched_copy(root, work, bign=False, map_kernels=False, mlap=False):
    src = os.path.join(os.path.abspath(root), "meta_learning_pacoh_torch")
    dst = os.path.join(work, "meta_learning_pacoh_torch")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = os.path.join(dst, "csrc")
    if mlap:
        with open(os.path.join(csrc, "fused_mlap.cu")) as f:
            layout = (MLAP_SPLIT if os.path.exists(os.path.join(csrc, "fused_mlap.cuh"))
                      else MLAP_CLUSTER if '#include "cluster_score.cuh"' in f.read()
                      else MLAP_ONE_BLOCK)
    elif map_kernels:
        layout = map_layout(csrc)
    elif bign:
        layout = BIGN_TILED if os.path.exists(os.path.join(csrc, "tiled_inverse.cuh")) else BIGN_COLUMN
    else:
        layout = CLUSTER if os.path.exists(os.path.join(csrc, "cluster_score.cuh")) else ONE_BLOCK
    texts = {}

    def text(name):
        if name not in texts:
            with open(os.path.join(csrc, name)) as f:
                texts[name] = f.read()
        return texts[name]

    if mlap:
        body = "fused_mlap.cuh" if layout is MLAP_SPLIT else "fused_mlap.cu"
        texts[body] = patch(text(body), "namespace {\n", PROF)
    elif bign or map_kernels:  # the patched headers are included by several sources: marks in each
        for name in os.listdir(csrc):  # (B8's sources open their namespace in fused_mlap.cuh)
            if name.endswith(".cu") and "namespace {\n" in text(name):
                texts[name] = patch(text(name), "namespace {\n", PROF)
    else:
        texts[layout["header"]] = patch(text(layout["header"]), "namespace {\n", PROF)
    for name, anchor, insert, *how in layout["patches"]:
        try:
            texts[name] = patch(text(name), anchor, insert, *how)
        except RuntimeError as e:
            raise RuntimeError(f"{e} (in {name})") from None
    kinds = (("mlap",) if mlap else ("map", "map_bign") if map_kernels
             else ("svgd_bign", "vi_bign") if bign else ("svgd", "vi"))
    for label in kinds:
        texts[f"fused_{label}.cu"] = text(f"fused_{label}.cu") + READER % label
    for name, body in texts.items():
        with open(os.path.join(csrc, name), "w") as f:
            f.write(body)
    return layout


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(HERE))
    parser.add_argument("--work", default=os.path.join(os.path.dirname(HERE), "_scratch_tree",
                                                       "phase_profile"))
    parser.add_argument("--out")
    parser.add_argument("--bign", action="store_true", help="profile B10 and B11 instead")
    parser.add_argument("--map", action="store_true", help="profile B9 and B6 instead")
    parser.add_argument("--mlap", action="store_true", help="profile B8 instead")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("fused_phase_profile: no CUDA device")
    layout = patched_copy(args.root, os.path.abspath(args.work), args.bign, args.map, args.mlap)
    sys.path.insert(0, os.path.abspath(args.work))
    from meta_learning_pacoh_torch.ops.cuda import build

    lib = build.library()
    steps = BIGN_STEPS if args.bign else STEPS
    if args.mlap:
        runs = mlap_runs()
    elif args.map:
        runs = map_runs()
    elif args.bign:
        runs = bign_runs(steps)
    else:
        runs = fused_runs(steps)
    result = {"root": os.path.abspath(args.root), "layout": layout["header"]}
    buf = (ctypes.c_longlong * N_MARKS)()
    for label, (kind, run, *own) in runs.items():
        steps = own[0] if own else steps
        read = getattr(lib, f"pacoh_prof_read_{kind}")
        read.argtypes = [ctypes.c_void_p]
        run(10)
        torch.cuda.synchronize()
        read(buf)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(steps)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / steps
        err = read(buf)
        if err:
            raise RuntimeError(f"fused_phase_profile: reading the marks failed ({err})")
        phases = {name: buf[i] / steps for i, name in layout[kind].items() if i != 0}
        total = sum(phases.values())
        print(f"{label} ({layout['header']}): {ms:.5f} ms a step (profiled build); "
              f"cycles a step by phase, block 0 ({total:.0f} in all):")
        for name, cyc in phases.items():
            print(f"  {name:58s} {cyc:10.0f}  {100 * cyc / total:5.1f}%")
        result[label] = {"ms_per_step": ms, "cycles": phases}
    query = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"]
    card = subprocess.run(query, capture_output=True, text=True, check=True, timeout=60)
    result["card"] = card.stdout.strip()
    print(result["card"])
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


def bign_runs(steps):
    """label -> (kernel, run(n_steps)): B10 and B11 at svgd_t5_n200 /
    vi_t5_n200 and B10 at cauchy_20 and N=9, from the learners' initial
    states (chip_smoke.py's learners)."""
    import numpy as np
    import torch

    sys.path.insert(1, os.path.dirname(HERE))
    import chip_smoke as cs
    from meta_learning_pacoh_torch.ops.cuda import fused_svgd_bign_kernel as sb
    from meta_learning_pacoh_torch.ops.cuda import fused_vi_bign_kernel as vb
    from meta_learning_pacoh_torch.ops.cuda import fused_vi_kernel as vk

    train, _ = cs.bign_data()
    cauchy, _ = cs.cauchy20()
    kw = dict(hidden=(32, 32), wps=0.5, bps=3.0)

    def svgd(model):
        data = (model.X, model.Y, model.mask)
        w_t = sb.FusedSVGDBigNTrainer(*data, hidden=(32, 32), lr=1e-3, prior_factor=0.01,
                                      weight_prior_std=0.5, bias_prior_std=3.0).w_t
        state = [model.particles.clone(), torch.zeros_like(model.particles),
                 torch.zeros_like(model.particles)]
        return "svgd_bign", lambda n: sb.fused_svgd_bign_train(*state, *data, w_t, 0, 1e-3, 0.01,
                                                              n_steps=n, **kw)

    vi = cs.bign_vi_model(train)
    data = (vi.X, vi.Y, vi.mask)
    w_t = sb.FusedSVGDBigNTrainer(*data, hidden=(32, 32), lr=1e-3, prior_factor=0.01,
                                  weight_prior_std=0.5, bias_prior_std=3.0).w_t
    eps = torch.from_numpy(np.random.RandomState(0).randn(steps, 10, vi.hyper_prior.dim)
                           .astype(np.float32)).to(vi.X.device)
    mll_const = vk.mll_constant(vi.mask.cpu().numpy())
    post = cs.vi_state(vi)
    return {
        "svgd_t5_n200": svgd(cs.bign_svgd_model(train)),
        "vi_t5_n200": ("vi_bign", lambda n: vb.fused_vi_bign_train(
            *post, *data, w_t, eps[:n].contiguous(), 0, 1e-3, 0.01, mll_const=mll_const,
            n_steps=n, **kw)),
        "cauchy_20 (B10)": svgd(cs.bign_svgd_model(cauchy, seed=30)),
        "N=9, 5 tasks (B10)": svgd(cs.bign_svgd_model(cs.faceoff_tasks(5, 9))),
    }


def map_runs():
    """label -> (kernel, run(n_steps), steps): B9 at map_t5_n200 (100 steps a
    launch) and B6 at the demo's shapes, counted and full batch (200),
    from the learners' initial states (chip_smoke.py's learners)."""
    import torch

    sys.path.insert(1, os.path.dirname(HERE))
    import chip_smoke as cs
    from meta_learning_pacoh_torch.ops.cuda import fused_map_bign_kernel as bg
    from meta_learning_pacoh_torch.ops.cuda import fused_map_kernel as mk

    def state(model):
        return [model.params.clone(), torch.zeros_like(model.params),
                torch.zeros_like(model.params)]

    big = cs.bign_model(cs.bign_data()[0])
    big_tr = big._fused_trainer()
    big_s = state(big)
    demo = cs.demo_model(cs.sin20()[0])
    tr = demo._fused_trainer()
    counts = tr.count_pages(0, STEPS)
    full_s, counted_s = state(demo), state(demo)
    data = (demo.X, demo.Y, demo.mask, tr.w_t)
    return {
        "map_t5_n200 (B9)": ("map_bign", lambda n: bg.fused_map_bign_train(
            *big_s, big.X, big.Y, big.mask, big_tr.w_t, 0, 1e-3, 0.0, layout=big.layout,
            n_steps=n), BIGN_STEPS),
        "demo, counted batch of 5 (B6)": ("map", lambda n: mk.fused_map_train(
            *counted_s, *data, 0, 1e-3, 0.2, counts[:n].contiguous(), layout=demo.layout,
            n_steps=n), STEPS),
        "demo, full batch (B6)": ("map", lambda n: mk.fused_map_train(
            *full_s, *data, 0, 1e-3, 0.2, layout=demo.layout, n_steps=n), STEPS),
    }


def mlap_runs():
    """label -> (kernel, run(n_steps), steps): B8 at bench.py's mlap shapes
    from the learner's initial state and its own pages, counted and full
    batch, and in meta-test mode at T=5 (five test context sets) and T=20
    (chip_smoke.py's learners)."""
    sys.path.insert(1, os.path.dirname(HERE))
    import chip_smoke as cs
    from meta_learning_pacoh_torch.ops.cuda import fused_mlap_kernel as mk

    train, test = cs.sin20()
    model = cs.mlap_model(train)
    ctx = cs.mlap_model([t[:2] for t in test[:5]])
    kw = dict(hidden=(32, 32), wps=0.5, bps=3.0, task_kl_weight=1.0, meta_kl_weight=1e-3,
              delta=0.1, n_tasks=20)
    trainer = mk.FusedMLAPTrainer(
        model.X, model.Y, model.mask, hidden=(32, 32), lr=1e-3, posterior_lr_multiplier=1.0,
        svi_batch_size=model.svi_batch_size, task_batch_size=20, task_kl_weight=1.0,
        meta_kl_weight=1e-3, delta=0.1, weight_prior_std=0.5, bias_prior_std=3.0,
        eps_draw=model._draw_eps, task_draw=model._task_draw)
    eps, counts = trainer.eps_pages(0, STEPS), trainer.count_pages(0, STEPS)
    counted, full, mt20, mt5 = (cs.mlap_state(m) for m in (model, model, model, ctx))

    def fit(state, cnt):
        return lambda n: mk.fused_mlap_train(
            *state, model.X, model.Y, model.mask, eps[:n].contiguous(),
            None if cnt is None else cnt[:n].contiguous(), 0, 1e-3, 1e-3,
            batch=None if cnt is None else 20, n_steps=n, **kw)

    def meta_test(state, m):
        return lambda n: mk.fused_mlap_train(
            *state, m.X, m.Y, m.mask, eps[:n].contiguous(), None, 0, 0.0, 1e-2, meta_test=True,
            n_steps=n, **kw)

    return {
        "mlap, counted (the learner's pages)": ("mlap", fit(counted, counts), STEPS),
        "mlap, full batch": ("mlap", fit(full, None), STEPS),
        "mlap meta-test, T=20": ("mlap", meta_test(mt20, model), STEPS),
        "mlap meta-test, T=5": ("mlap", meta_test(mt5, ctx), STEPS),
    }


def fused_runs(steps):
    """label -> (kernel, run(n_steps)): B2 and B7 at sin_20's shapes."""
    import numpy as np
    import torch

    from meta_learning_pacoh_torch.ops.cuda import fused_svgd_kernel as fk
    from meta_learning_pacoh_torch.ops.cuda import fused_vi_kernel as vk

    sys.path.insert(0, HERE)
    from fused_step_bench import sin20_arrays

    dev = torch.device("cuda")
    x, y, mask = (torch.from_numpy(a).to(dev) for a in sin20_arrays())
    hidden, k = (32, 32), 10
    hp = fk.fused_prior(x.shape[-1], hidden, 0.5, 3.0)
    rs = np.random.RandomState(10)
    theta = (hp.loc + hp.scale * torch.from_numpy(rs.randn(k, hp.dim).astype(np.float32))).to(dev)
    w_t = torch.from_numpy(fk.task_weights(mask.cpu().numpy())).to(dev)
    eps = torch.from_numpy(rs.randn(steps, k, hp.dim).astype(np.float32)).to(dev)
    svgd_state = [theta.clone(), torch.zeros_like(theta), torch.zeros_like(theta)]
    post = [0.1 * torch.randn(hp.dim, device=dev), torch.full((hp.dim,), -2.0, device=dev)]
    post += [torch.zeros(hp.dim, device=dev) for _ in range(4)]
    return {
        "svgd": ("svgd", lambda n: fk.fused_svgd_train(*svgd_state, x, y, mask, w_t, 0, 1e-3, 0.01,
                                                       hidden=hidden, wps=0.5, bps=3.0,
                                                       n_steps=n)),
        "vi": ("vi", lambda n: vk.fused_vi_train(*post, x, y, mask, w_t, eps[:n].contiguous(), 0,
                                                 1e-3, 0.01, hidden=hidden, wps=0.5, bps=3.0,
                                                 mll_const=vk.mll_constant(mask.cpu().numpy()),
                                                 n_steps=n)),
    }


if __name__ == "__main__":
    main()
