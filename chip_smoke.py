#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PACOH (SVGD, MAP, VI, MLAP, GPR-MLL, GPR-PAC, MAML and NP, alone, stacked and on a device mesh, and through the experiment CLIs and the computational comparison) once on one NVIDIA GPU.

    python3 chip_smoke.py                # all phases, one card
    python3 chip_smoke.py --profile DIR  # also trace fit steps and one eval of
                                         # each path with torch.profiler, tables into DIR

Phase 0 requires CUDA and prints the card's name and power limit.
Phase 1 builds the hand-written kernels from ``meta_learning_pacoh_torch/csrc``.
Phase 2 holds each kernel against its plain PyTorch version on the card, at
the shapes its main path gives it, and times both; the pure kernels (K1-K4,
B4, B5) as device time (``device_pair``: calls queued behind a device-side
wait, then an event pair around 100 of them), with the single-call wall
beside it: K1 at ``cauchy_20``'s [10, 2372] and at its SE learner's [10,
1188] (the cluster plans printed), at K=1 (against exact distances) and
K=32 (also at P=20000, past the staged slices), at a ragged P=2371, at
P=37 and P=3 (smaller than one CTA's slice), two calls giving the same
bits, on a seed axis (one launch of S clusters) at [1, 10, 2372] (the bits
of the [K, P] call) and at phase 12's [5, 10, 2372] and [4, 10, 2308]
(rows of their own in the kernels line); K2 on escalating systems at B=200, N=20
(timed beside ``cholesky_ex``), at B=1, at B=1000 and B=7 (no multiple of
the systems a block) and at N in {32, 33, 48, 64}, each batch but the timed
one with a system that fails at every jitter level (non-finite where the
plain version is); K3 on the plain version's and on K2's own L and z (timed
beside ``cholesky_inverse``); ptxas' registers and spills of both kernels'
instances (none may spill);
K4 at the evals' B=2000 and B=200 (N=200, beside ``torch.linalg.cholesky_ex``),
at its tiles' and shared-memory edges N in {65, 96, 97, 129, 308, 309, 512},
with its resident blocks per SM,
the fused SVGD training kernel B2 at ``sin_20``'s (full batch, a sampled
batch, and a run across a staircase boundary of the lr schedule; its
cluster plan, the clusters the card holds at once, ptxas' registers and
spills, and its time a step at K=10 and K=32), the fused
MAP training kernel B6 at the reference demo's (the same three runs, and one
odd shape: 7 ragged tasks, D=3, F=3, nets of other depths and widths; one
thread-block cluster; also nets (7, 7) on the scalar passes, 200 tasks,
and 1000 tasks of 8 points on the first design's cooperative grid), the
fused VI training kernel B7 at the sin_20 VI fit's (the same three runs, and
one odd shape: S=3, 7 ragged tasks of up to 7 points, D=2, nets (16,16,16);
its cluster plans and times a step at S=10, S=32 and the odd shape),
the blocked MLL kernels B4 (forward and backward) at bench.py's B=200, N=200,
at the general steps' B=5 (MAP) and B=50 (SVGD), N=200 (the forward beside
``cholesky_ex``, the backward beside ``cholesky_inverse``), at N in {49, 231,
232, 512}, and on one batch whose systems escalate to 1e-4 and 1e-2 (the
backward also fed the forward kernel's L and z), both also at their tiles'
and shared-memory edges (N in {65, 96, 97, 129, 206, 207, 208, 235, 236,
306, 307, 308}), with their resident blocks per SM, a failed system NaN through both
and dKn exactly symmetric, and the
big-N fused MAP
kernel B9 at the ``map_t5_n200`` shapes (full batch, a sampled batch, across
a staircase) and one odd shape (ragged tasks of up to 300 points, D=2, F=3,
nets (16,16,16)), also at 3 tasks of 512 points, nets (7, 7)
at N=48 (the scalar passes), F=3 with nets (12,20,4)/(8,16) at N=33, 200
tasks of 12 points (two a block), and on duplicated inputs with an
outputscale of softplus(1000) and a noise of softplus(-30), where float32
escalates and float64 does not (held to the float64 plain version at the
float32 levels), the small-matrix Cholesky B5 at N in {32, 50, 64} and B in
{1, 20, 200, 257} and on a batch with an indefinite matrix, and the fused
MLAP kernel B8 at bench.py's ``mlap`` shapes from a well-conditioned state
(full batch, a sampled batch, across a staircase, the meta-test mode at 20
and at 5 tasks, one odd shape: S=3, 7 ragged tasks, D=2, nets (16,16,16)),
each at every cluster size its plan can return, and by one gradient at the
sin_20 learner's own initial state (its cluster plans, the clusters the card
holds at once, ptxas' registers and spills), and the big-N fused SVGD and VI
kernels B10 and B11 at the ``svgd_t5_n200`` / ``vi_t5_n200`` shapes (full
batch, a sampled batch, across a staircase), at ``cauchy_20``'s (20 tasks of
20 points, D=2: two systems a block; also timed) and three odd shapes (3
ragged tasks of up to 240 points, D=2, nets (16,16,16): the packed matrix in
shared memory, the activations in device memory; the same tasks with nets
(128,128): both in device memory; 26 ragged tasks of up to 20 points: two
systems a block), and the single-task paths' shapes at one system a launch
(B4 forward and backward and K4 at N=200, K2 and K3 at N=20, each with a
system failing at every level, timed beside ``cholesky_ex`` and
``cholesky_inverse``); last, after those cases and their draws, B2 and B7
at T=320 and 512 (``sin_20``'s learners, N=5) and B8's fit at T=160 and 512
and its meta-test mode at T=200 and 512 (mlap's learner from
``conditioned_state``), each against its plain version with the same
limits, its plan (tiled where a CTA's tasks do not fit), its time a step and
its bound (``phase2_many_tasks``).
Phase 3 runs ``cauchy_20`` through the public entry points:
``provide_data("cauchy_20", seed=28)``,
``GPRegressionMetaLearnedSVGD(..., device="cuda")``, ``meta_fit`` and
``eval_datasets`` on all 200 test tasks, as the learner dispatches it (B10
alone in the fit, its counter at 0 before and above 0 after); then twins
of the fit and of the eval from one state, with the kernels disabled and
with the fused kernel disabled (the general step: K1-K3), compared with
B10's; from the state 200 steps later, B10 against its plain version in
float64, and B10's moments and the general step's particles within twice
the JAX float32 step's own drift from its float64 run there
(tools/c1_drift.json);
then the same learner with the SE covariance of the experiments'
``--covar_module SE``, whose fit takes the general step by default, with
the counters of K1-K4 at 0 before its fit and eval and above 0 after.
Phase 4 runs the ``sin_20`` main path of ``bench.py`` (the fused path): a
10,000-step ``meta_fit`` carried by B2 alone (its counter above 0, those of
the general step's kernels at 0; B2 in clusters of more than one CTA, more
than 10 CTAs in all), the steady rate of a second 10,000-step
call, ``eval_datasets`` on the 20 test tasks, two chunkings that must give
the same bits, and seeds 30-32 whose mean test LL and RMSE must lie in the
band of the JAX package's (BENCH_r05).
Phase 5 runs the reference demo's main path (PACOH-MAP, demo.py):
``GPRegressionMetaLearned(train, weight_decay=0.2, num_iter_fit=12000,
random_seed=30)`` built without a device (so on the card by default), a
12,000-step ``meta_fit`` (task batch 5, count-weighted) carried by B6 alone,
the steady rate of a second call, ``eval_datasets`` cold and warm,
``confidence_intervals``, two chunkings that must give the same bits, seeds
30-32 in the band of the JAX package's (tools/map_demo_band.json), and the
steady rate of a full-batch fit.
Phase 6 runs the sin_20 PACOH-VI main path: ``GPRegressionMetaLearnedVI(train,
random_seed=30)`` with the learner's defaults, built without a device, a
10,000-step ``meta_fit`` carried by B7 alone (one launch per 512 steps), the
steady rate of a second call, the host's cost of the noise pages,
``eval_datasets`` cold and warm, ``confidence_intervals``, two chunkings that
must give the same bits, the general step's rate over 100 steps
(``PACOH_TORCH_DISABLE_FUSED=1``), and seeds 30-32 in the band of the JAX
package's (tools/vi_band.json).
Phase 7 runs bench.py's ``map_t5_n200`` path: ``GPRegressionMetaLearned(train,
num_iter_fit=500, random_seed=1, task_batch_size=-1)`` on 5 tasks x 200
points, built without a device: a 500-step ``meta_fit`` carried by B9 alone,
the steady rate of a second call, ``eval_datasets`` on 20 test tasks of 200
context and 200 test points cold and warm (their factorizations through K4),
``confidence_intervals``, two chunkings that must give the same bits, 20
general steps (``PACOH_TORCH_DISABLE_FUSED=1``, through B4) that must agree
with B9's 20 from the same state, 500 B9 steps from the JAX learner's initial
parameters held to the JAX run recorded in tools/map_bign_ref.json, and 20
general steps of bench.py's ``svgd_t5_n200`` learner
(``PACOH_TORCH_DISABLE_FUSED=1``, through B4).
Phase 8 runs bench.py's ``mlap`` path: ``GPRegressionMetaLearnedPAC(train,
num_iter_fit=2000, random_seed=1, covar_module="NN", mean_module="NN",
meta_kl_weight=1e-3)`` on the sin_20 data, built without a device: a
2,000-step ``meta_fit`` carried by B8 alone, the steady rate of a second
call, bench.py's meta-test row (3,000 steps on 5 context sets, two warm
calls, then 5 timed), ``eval_datasets`` cold and warm (its meta-test through
B8, its 50-point predictive covariances through B5), ``confidence_intervals``
with ``n_iter_meta_test=300``, two chunkings that must give the same bits, 20
general steps (``PACOH_TORCH_DISABLE_FUSED=1``) that must agree with B8's from
one well-conditioned state, and seeds 30-32 in the band of the JAX
package's (tools/mlap_band.json). Phases 4-6 report their evals' B5 launches.
Phase 9 runs bench.py's ``svgd_t5_n200`` and ``vi_t5_n200`` paths
(bench.py:166-176: 5 tasks x 200 points, K = S = 10, ``prior_factor=0.01``,
VI diag, full batch, seed 1), each learner built without a device: a
500-step ``meta_fit`` carried by B10 (B11) alone, the steady rate of a
second call, ``eval_datasets`` on 20 test tasks of 200 context and 200 test
points cold and warm (K4), two chunkings that must give the same bits, 20
steps from the initial states of seeds 1-3 through the kernel, through the
general step (``PACOH_TORCH_DISABLE_FUSED=1``: B4, and K1 for SVGD; VI with
the same noise) and through the kernel's plain version in float64 (the
kernel within the twins' tolerances of the float64 run, the general step
within a fixed limit of its own; the next step's VI loss on both paths),
the faceoff of the steady rates, seeds 30-32 in the band of the JAX
learners (tools/bign_band.json), 50 B10 steps from the JAX learner's
initial particles held to its run (tools/svgd_bign_ref.json), and the
faceoff of both learners' fused and general rates at the corners of the
big-N window (N from 9 to 256, 50 to 1000 systems, and ``cauchy_20``),
each of which must agree with the learners' default dispatch.
Phase 10 runs the single-task learners and the custom modules on the paths
of tools/single_task_ref.py, each learner built without a device at seed 30
with its defaults: ``GPRegressionLearned`` on the first ``map_t5_n200`` test
task's 200 context points (B4 at B=1) and on the first ``cauchy_20`` test
task's 20 (K2/K3), ``GPRegressionLearnedPAC`` on the former (K4 three times a
step), ``GPRegressionLearned(covar_module=CosineKernel(),
mean_module=LinearMean())`` on it (B4), each 1,000 steps in chunks of 250 with
the task's 200 test points as the validation set, and
``GPRegressionMetaLearned(covar_module=MaternKernel(2.5),
mean_module=LinearMean())`` on ``map_t5_n200``'s 5 tasks, 500 general steps
(B4 at B=5). Each fit and eval must count exactly its kernels' launches; then
the eval cold and warm, the steady rate, ``confidence_intervals``, 20 steps
against the same learner with the kernels disabled (GPR-PAC: against its
float64 plain run, within ``PAC_TWIN_F64``), 200 steps from the JAX learner's
initial parameters against its CPU run (tools/single_task_ref.json), and for
GPR-MLL and GPR-PAC seeds 30-32 in the band of tools/single_task_band.json.
Phase 11 runs the reference paper's baselines, which reach no hand-written
kernel: ``MAMLRegression`` and ``NPRegressionMetaLearned`` with their
defaults on ``provide_data("sin_20", seed=28)``, as
experiments/baselines/baseline_comparison.py runs them, each built without
a device (on the card, TF32 off): a 10,000-step ``meta_fit`` at seed 30
(its metrics read after 2,000 steps on the way), ``eval_datasets`` on the
first 50 test tasks cold and warm, the steady rate of a further 500 steps,
the NP's ``confidence_intervals``, 200 steps from the JAX learner's initial
state with its draws against its CPU run (tools/maml_np_ref.json; the NP in
float64 on both sides), the same steps in float32 on the card against the
CPU (the twin), and seeds 30-32 at 2,000 steps in the band of
tools/maml_np_band.json; then ``NeuralProcessImg`` with its defaults trained
by its trainer for 2 epochs through ``mnist_image_batches`` on 64 synthetic
images of 28 x 28 (a gzipped IDX3 file in a temporary directory), its loss
on a held batch with fixed masks and latents lower after, and ``inpaint``.
No kernel may launch in phase 11.
Phase 12 runs the stacked fits (``parallel.fit_models_parallel``,
``utils.tuning_parallel``, ``utils.tuning.tune_run``), each learner built
without a device. 12a: the meta-overfitting sweep's seeds 22-26
(experiments/meta_overfitting/run_overfitting_sweep.py:25) as one stacked
PACOH-SVGD fit on cauchy_20, each seed its own ``provide_data("cauchy_20",
seed)``, K=10, full batch, ``prefer="vmap"``, 500 steps: exactly 500
launches each of K1 (at [5, 10, 2372]), K2 and K3 (1,000 systems of N=20);
each seed's eval (20 test tasks, K4) within rtol 1e-3 of its own
sequential general-step fit; 20 steps from the fitted states, stacked
against the stack with the kernels off (the twins' limits) and each float32
run (stacked, each seed alone, kernels off) against the plain stack in
float64 (twice the JAX float32 step's drift, tools/c1_drift.json); the
stacked rate beside one fit's general step (``--profile``: both traced).
12b: the sweep's PACOH-MAP cell on sin_32 (run_overfitting_sweep.py:41-80:
weight decay 0.1, 50 test tasks), seeds 22-26, through 'vmap' (1,000
stacked steps, no kernel at N=5) and 'sequential_fused' (10,000 B6 steps
each), both evaluated as the sweep does; the faster route a fit-step must
be the one ``prefer="auto"`` takes. 12c: ``run_trial_batch`` on phase 4's
sin_20 data: SVGD trials (lr x prior_factor, median bandwidth: exactly 500
K1 launches at [4, 10, 2308]), VI trials (the same grid) and MAP trials (lr
x weight decay), 4 each, 500 steps, each trial within the twins' limits of
its own general-step fit after 20 steps; then ``tune_run`` with TPE,
``batch_size=4``, ``batch_trial_fn=run_trial_batch``, two rounds of MAP
trials of 300 steps, none falling back to a sequential trial.
Phase 13 runs the multi-device layer in this process over ``make_mesh()``,
a one-rank NCCL mesh on the card (the backend and world size printed), each
path against its run without a mesh. 13a: ``distributed_cholesky`` at N in
{520, 1000 (the identity tail), 1024, 2048, 4096}, blocks of 128 (K4 one
launch a block), against ``cholesky_ex`` (the factor within 1e-4 of its
largest entry, ||LL^T - A|| / ||A|| below 1e-5), its device time beside
``cholesky_ex``'s (calls queued behind a device-side wait), its kernels'
sum and its single-call wall; ``distributed_gp_mll``'s value and gradient
at N=1024 against a float64 plain run (1e-4), the single-device path's gap
beside. 13b: PACOH-MAP at its default widths on 5 sinusoid tasks of 1,024
points with ``mesh=``, 20 steps through the tier (K4 launched, B9 not)
against the learner without a mesh (``torch.linalg`` above 512 points)
within the twins' limits, and one ``eval_datasets``. 13c: GPR-MLL on one
task of 2,048 points, 20 steps, the same way. 13d: ``cauchy_20``'s SVGD as
phase 3 builds it with ``mesh=``, 50 general steps (K1-K3 launched, B10
not) against the learner without a mesh under ``PACOH_TORCH_DISABLE_FUSED=1``.
13e: ``map_t5_n200`` with ``mesh=``, 20 steps (B4) against its general step.
13f: ``build_svgd_parallel_step`` for 20 steps against the learner's
general step; ``fit_models_parallel`` of five ``cauchy_20`` seeds on
``make_seed_mesh()`` and ``fit_svgd_hyper_parallel`` of three ``sin_20``
trials with ``mesh=``, against the same calls without; MLAP's meta-test of
20 tasks sharded over the mesh against the learner without one. Whether
each path's bits agree with its run without a mesh is printed; phase 13's
launches enter the kernels line's counts.
Phase 14 runs the experiment CLIs of ``meta_learning_pacoh_torch.experiments``
and the demo in this process through their ``main(argv)``, on the card by
default, into a temporary directory, at the default nets (32, 32) and
sin_20's 20 tasks of 5 points, only the steps cut; each run's launches are
printed. The six per-algorithm CLIs at ``--n_iter_fit 500`` (SVGD, VI and
MLAP with ``--feature_dim 1``, the learners' default, which their fused
kernels take): MAP through B6, SVGD B2, VI B7, MLAP B8, MAML and the NP no
kernel; each results.json finite, its run directory ``hash_dict`` of its
flags, and its metrics the bits of the learner built here with the same
keywords and fitted the same way. The baseline comparison on sin_20 (five
algorithms, seed 22, 300 steps, 10 test tasks: 5 rows, none failed), its
n-tasks variant on sin_5 (PACOH-MAP, seeds 22 and 23) and the summary of
the first CSV. The meta-overfitting sweep (PACOH-MAP, 4 and 8 tasks, weight
decay 0.1, seeds 22-24, 300 steps) with and without ``--seed_parallel``: 6
rows each, no fallback, B6 in both, the metric columns the same bits. The
hyperparameter search: PACOH-SVGD trials in stacked pairs with the
re-evaluation seeds fitted together (the space's numeric bandwidth takes the
plain RBF transport, not K1; K4 in the evals), PACOH-MAP trials in stacked
pairs (B6 in the re-evaluation); each
writes its CSV with no trial failed and no batch fallen back. The
launcher's commands, each parsed by the search's parser. The image NP
driver on synthetic IDX images (1 epoch of 64): finite losses, model.pkl
loaded into a fresh model predicts the bits of the same training run driven
directly. The demo in full: its LL, RMSE and calibration the bits of phase
5's demo fit.
Phase 15 drives many tasks through the learners' entry points, the fits'
steps cut to ``MANY_STEPS``: ``baseline_comparison_n_tasks``'s ``sin_160``
and ``sin_320`` PACOH-SVGD and PACOH-VI learners (its ``build_cell``, seed
22), each fit carried by B2 or B7 alone (one launch, no kernel of the general
step), its twin with ``PACOH_TORCH_DISABLE_FUSED=1`` fitted as long (both
walls printed), and 20 steps of each from the fused fit's state within the
twin limits, their evals on 20 test tasks too; a PACOH-MLAP fit on
``sin_160`` (mlap's learner) carried by B8 alone and its general twin's
wall, and B8 against the general step for 20 steps from
``conditioned_state`` at 160 tasks, as phase 8 holds it; the MLAP CLI's
eval of 200 test tasks of sin_20's environment, after bench.py's 2,000-step
fit at seeds 30-32, through B8's meta-test mode (one launch a 512-step
block of the 3,000-step meta-test, no general loop), the seeds' mean LL and
RMSE in the band of ``tools/mlap_band.json``, the walls of a 300-step eval
with the kernel and with ``PACOH_TORCH_DISABLE_FUSED=1``, and the meta-test
of 200 conditioned context sets through B8 against the general loop, 20
steps from one state and one set of draws, within the twin limits.
Phase 16 runs the paper's computational comparison,
``meta_learning_pacoh_torch.experiments.computational_comparison``, through
its ``main(argv)`` at its defaults, on the card by default: PACOH-MAP,
-SVGD, -VI and -MLAP (NN/NN, ``meta_kl_weight=1e-3``) on ``sin_20``, each a
cold 1,000-step ``meta_fit`` and five warm ones, then two ``eval_datasets``
of five test tasks (MLAP's with a 1,000-step meta-test). Every fit must be
carried by the learner's fused kernel alone (B6, B2, B7, B8) in the launches
its trainer plans, each MLAP eval by two launches of B8's meta-test mode, no
other eval by a fused kernel; the rows finite and positive, the written JSON
the returned dict. Its twin at ``--n_iter 100 --n_repeats 1`` with
``PACOH_TORCH_DISABLE_FUSED=1`` (the general steps, no fused kernel) puts
the general step's ms/iter and s/task beside each row; the main run's
launches enter the kernels line's counts.

Any failure raises and exits non-zero. The line before the last is a JSON
object with one record per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

SOURCE = "meta_learning_pacoh_torch/csrc/"
TPU = "meta_learning_pacoh_tpu/ops/pallas/"
KERNELS = {  # launch-counter name -> (source, TPU kernel it replaces)
    "svgd_phi": (SOURCE + "svgd_phi.cu", TPU + "svgd_kernel.py:73"),
    "mll_fwd": (SOURCE + "mll.cu", TPU + "mll_kernel.py:192"),
    "mll_bwd": (SOURCE + "mll.cu", TPU + "mll_kernel.py:223"),
    "chol": (SOURCE + "chol.cu", TPU + "blocked_mll_kernel.py:820"),
    "fused_svgd": (SOURCE + "fused_svgd.cu", TPU + "fused_train_kernel.py:789"),
    "fused_map": (SOURCE + "fused_map.cu", TPU + "fused_map_kernel.py:416"),
    "fused_vi": (SOURCE + "fused_vi.cu", TPU + "fused_vi_kernel.py:459"),
    "blocked_fwd": (SOURCE + "blocked_mll.cu", TPU + "blocked_mll_kernel.py:715"),
    "blocked_bwd": (SOURCE + "blocked_mll.cu", TPU + "blocked_mll_kernel.py:754"),
    "fused_map_bign": (SOURCE + "fused_map_bign.cu", TPU + "fused_map_bign_kernel.py:391"),
    "chol_small": (SOURCE + "chol_small.cu",
                   TPU + "chol_kernel.py:64 and " + TPU + "chol_kernel.py:115"),
    "fused_mlap": (SOURCE + "fused_mlap.cuh", TPU + "fused_mlap_kernel.py:553"),
    "fused_svgd_bign": (SOURCE + "fused_svgd_bign.cu", TPU + "fused_svgd_bign_kernel.py:452"),
    "fused_vi_bign": (SOURCE + "fused_vi_bign.cu", TPU + "fused_vi_bign_kernel.py:258"),
}
# the card's peaks for the bound (NVIDIA's H100 SXM data sheet): float32 off
# the tensor cores, and device memory
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
GENERAL_STEP_KERNELS = ("svgd_phi", "mll_fwd", "mll_bwd", "chol")
# K1 on a seed axis, rows of the kernels line of their own: (S, K, P) of
# phase 12a's five cauchy_20 seeds and phase 12c's four sin_20 SVGD trials
K1_SEED_ROWS = {"svgd_phi seeds [5, 10, 2372]": (5, 10, 2372),
                "svgd_phi trials [4, 10, 2308]": (4, 10, 2308)}
# per-system error, normalised by the system's largest |plain| value
KERNEL_RTOL = 2e-4
# the pure kernels' device time: calls queued behind a device-side wait of
# this many cycles a second of host enqueue time (above the H100's 1980 MHz)
QUEUED_RUN, SLEEP_CYCLES_PER_S = 100, 2.5e9
PROFILED_CALLS = 20  # calls of a plain version whose kernels torch.profiler sums
# how each plain version's and library call's device time was taken, by
# "<kernel> plain" / "<kernel> library": "queued", or "kernel sum" for a call
# that reads back to the host and so cannot be queued: its function waits in
# UNQUEUED until settle_kernel_sums, after the last phase, since a
# torch.profiler session may slow the host's later launches, which phases 3-9
# time ("host included" until then)
TIMED_AS = {}
UNQUEUED = {}
# phase 2's times at one system a launch (phase 10's shapes), by kernel
ONE_SYSTEM = {}
FIT_STEPS = 500
TWIN_STEPS = 20
# particles after TWIN_STEPS Adam steps from one state: max difference a tenth
# of one step's reach (lr 1e-3), mean difference 2e-6
TWIN_ATOL, TWIN_MEAN_ATOL = 1e-4, 2e-6
EVAL_TWIN_TASKS = 20
EVAL_TWIN_TOL = 1e-3  # rtol and atol of LL, RMSE, calib
# B2 against its plain version from one sin_20 state: particles with the
# twins' tolerances above; Adam moments max |diff| over max |plain|
B2_STEPS, B2_STAIR_STEPS, B2_STAIR_TRANSITION = 20, 30, 10
B2_MOMENT_RTOL = 1e-4
SIN_STEPS = 10000  # bench.py's fit
SIN_CHUNK = 2500  # the second chunking
SIN_SEEDS = (30, 31, 32)
# BENCH_r05's seed-30-32 means at 10k steps (LL std 0.086, RMSE std 0.009):
# centre, margin = 3 sigma of the difference of two 3-seed means
SIN_LL_BAND, SIN_RMSE_BAND = (-0.146, 0.21), (0.309, 0.022)
# B6 against its plain version: parameters with the twins' tolerances above,
# AdamW moments as B2's, the loss of the last step rtol 1e-5
B6_STEPS, B6_STAIR_STEPS, B6_LOSS_RTOL = 20, 30, 1e-5
# where a big-N plan (B10, B11) holds a system's work areas
C1_DRIFT_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                             "c1_drift.json")
BIGN_PLACEMENT = {2: "the matrix and the activations in shared memory",
                  1: "the matrix in shared memory, the activations in device memory",
                  0: "the matrix and the activations in device memory"}
MAP_STEPS = 12000  # demo.py's fit
MAP_CHUNK = 3000  # the second chunking
# the band of seeds 30-32: tools/map_demo_band.json (written by
# tools/map_demo_band.py), the JAX learner on the CPU (count-weighted), seeds
# 30-59 at 12,000 steps (LL std 0.0885, RMSE std 0.0303; seeds 30-32 alone
# show half that spread): centre, margin = 3 sigma of the difference of a
# 3-seed mean and the 30-seed mean
MAP_BAND_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                             "map_demo_band.json")
# B7 against its plain version: as B6 (20 steps, 30 across a staircase)
B7_STEPS = 20
VI_STEPS = 10000  # the VI learner's num_iter_fit default
VI_CHUNK = 2500  # the second chunking
VI_GENERAL_STEPS = 100
# the band of seeds 30-32: tools/vi_band.json (written by tools/vi_band.py),
# the JAX learner on the CPU, seeds 30-59 at 10,000 steps; centre, margin = 3
# sigma of the difference of a 3-seed mean and the 30-seed mean
VI_BAND_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                            "vi_band.json")
# B4 against its plain version: (label, systems, N); the escalating batch
# gets systems whose factorization needs the 1e-4 and the 1e-2 jitter
B4_CASES = (("bench.py B=200, N=200", 200, 200), ("MAP general step B=5, N=200", 5, 200),
            ("svgd_t5_n200 general step B=50, N=200", 50, 200), ("N=49", 8, 49),
            ("N=231", 8, 231), ("N=232", 8, 232), ("N=512", 8, 512))
# the B4 forward and backward beside their plain versions at the 32-column
# tiles' edges, on both sides of the two-blocks-an-SM edges (N=206 backward,
# 207 forward), of the shared-memory edges (N=306 backward, 307 forward) and
# of the first backward's (N=235); B in {1, 5} as the tests
B4_EDGES = ((1, 65), (5, 96), (5, 97), (1, 129), (5, 206), (5, 207), (5, 208), (5, 235),
            (5, 236), (1, 306), (1, 307), (5, 308))
# K4 beside its plain version at the 32-column tiles' edges and on both sides
# of its shared-memory edge (N=308)
K4_EDGES = (65, 96, 97, 129, 308, 309, 512)
B4_ESCALATION = ("escalating systems, B=16, N=200", 16, 200)
BIGN_STEPS = 500  # bench.py's map_t5_n200 fit
BIGN_CHUNK = 125  # the second chunking
BIGN_TWIN_STEPS = 20  # B9 against the general step (B4), from one state
BIGN_REF_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                             "map_bign_ref.json")
# phase 9: 50 B10 steps from the JAX learner's initial particles against its run
# (tools/svgd_bign_ref.json, written by tools/svgd_bign_ref.py)
SVGD_BIGN_REF_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                                  "svgd_bign_ref.json")
# phase 9: the fused kernels and the general steps from the initial states of
# these seeds, BIGN_TWIN_STEPS steps each, against the kernels' plain versions
# in float64: the kernels within the twins' tolerances; the general step (a
# float32 order of its own: B4, autograd) within a fixed limit of its own, the
# (max, mean, moments) of BIGN_GENERAL_F64: twice the largest reading over
# seeds 1-8 of tools/torch_bign_policy.py on an H100 80GB HBM3 at 700 W
# (tools/torch_bign_policy.json: SVGD 2.061e-3, 5.09e-6, 5.02e-3; VI 1.25e-6,
# 2.53e-7, 2.63e-6), rounded up. At the hyper-prior's particles the float32
# general step flips gradients near zero that Adam's first steps turn into 2
# lr: SVGD's seeds 1 and 4 drift 2e-3, its other six under 6e-5
BIGN_DRIFT_SEEDS = (1, 2, 3)
BIGN_GENERAL_F64 = {"svgd_t5_n200": (5e-3, 2e-5, 2e-2), "vi_t5_n200": (3e-6, 6e-7, 6e-6)}
# the band of seeds 30-32 of svgd_t5_n200 and vi_t5_n200: tools/bign_band.json
# (written by tools/bign_band.py), the JAX learners on the CPU, seeds 30-59 at
# 500 steps; centre, margin = 3 sigma of the difference of a 3-seed mean and
# the 30-seed mean
BIGN_BAND_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                              "bign_band.json")
# the big-N dispatch's faceoff (phase 9) beyond the main path's shape: (label,
# tasks, points), K = S = 10, full batch; cauchy_20's tasks where tasks is
# None. The corners of the window: N from 9 to 256, G = 10 T from 50 to 1000
# (8 systems a block)
BIGN_FACEOFF = (("N=9, 5 tasks", 5, 9), ("cauchy_20", None, None), ("N=48, 5 tasks", 5, 48),
                ("N=128, 5 tasks", 5, 128), ("N=256, 5 tasks", 5, 256),
                ("N=200, 20 tasks", 20, 200), ("N=48, 100 tasks", 100, 48),
                ("N=256, 100 tasks", 100, 256))
FACEOFF_SECONDS = 0.3  # the steps timed at each faceoff shape, about
# B5 against its plain version: N x B, the per-system error as K4's
B5_NS, B5_BS = (32, 50, 64), (1, 20, 200, 257)
# B8 against its plain version: 30 steps (full batch, a sampled batch, across a
# staircase; the meta-test) with the twins' tolerances, on a state whose inner
# gram is well conditioned (conditioned_tasks); at the sin_20 learner's own
# initial state the gram is singular to float32 before its 1e-6 jitter, so a
# one-step gradient is compared there, against the plain version's own float32
# to float64 gap
B8_STEPS = 30
B8_GRAD_FACTOR = 10.0  # the kernel's gap to the float32 plain gradient, in units of that gap
MLAP_STEPS = 2000  # bench.py's mlap fit
MLAP_CHUNK = 700  # the second chunking
MLAP_META_TEST = 3000  # the meta-test's steps (bench.py:225-240)
MLAP_CI_META_TEST = 300
MLAP_TWIN_STEPS = 20  # B8 against the general step, from one state and one set of draws
# phase 2's many-task cases: B2 and B7 at these T (N=5, sin_20's nets), B8's
# fit and meta-test mode at these (mlap's shapes, a conditioned state)
MANY_B2_TASKS, MANY_B8_FIT_TASKS, MANY_B8_TEST_TASKS = (320, 512), (160, 512), (200, 512)
MANY_TIMED_STEPS = 200  # a timed launch of the many-task cases
# phase 15: many tasks through the learners' entry points, the fits' steps cut
# (from baseline_comparison_n_tasks' 10,000 and bench.py's mlap 2,000)
MANY_STEPS = 500
MANY_EVAL_TASKS = 200  # the MLAP CLI's test tasks
# the band of seeds 30-32: tools/mlap_band.json (written by tools/mlap_band.py),
# the JAX learner on the CPU, seeds 30-59 at 2,000 steps; centre, margin = 3
# sigma of the difference of a 3-seed mean and the 30-seed mean
MLAP_BAND_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                              "mlap_band.json")
# phase 10: the single-task learners and the custom modules. The paths and
# their learners (the learners' defaults: NN nets 32x32, feature_dim 2, lr
# 1e-3) are tools/single_task_ref.py's; the single-task fits take
# SINGLE_STEPS steps in chunks of SINGLE_LOG with the task's test points as
# the validation set (the plateau scheduler stepped after every chunk)
SINGLE_STEPS, SINGLE_LOG, CUSTOM_MAP_STEPS = 1000, 250, 500
SINGLE_PATHS = ("gpr_mll_n200", "gpr_mll_n20", "gpr_pac_n200", "custom_n200",
                "custom_map_t5_n200")
SINGLE_BAND_PATHS = ("gpr_mll_n200", "gpr_pac_n200")
SINGLE_SEEDS = (30, 31, 32)
SINGLE_REF_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                               "single_task_ref.json")
# the band of seeds 30-32: tools/single_task_band.json (written by
# tools/single_task_band.py), the JAX learners on the CPU, seeds 30-59 fitted
# as phase 10 fits; centre, margin = 3 sigma of the difference of a 3-seed
# mean and the 30-seed mean
SINGLE_BAND_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                                "single_task_band.json")
# GPR-PAC's twin: its KL factors the prior Gram with no noise, singular to
# float32 at N=200 (eigenvalues 1e-16 of the largest): there the float32
# plain version's parameters lie 3.0e-2 to 4.0e-2 max, 5.9e-4 to 7.4e-4 mean
# from its float64 run after 20 steps, its loss 1.3e-2 to 1.6e-2 off, and
# the kernel path 3.0e-3 max from the float32 plain version (seeds 1-8 on an
# H100 80GB HBM3 at 700 W, tools/single_task_twins.py into
# tools/single_task_twins.json), so no float32 path meets the twins' limits.
# The kernel path is held to the plain version in float64 with limits of its
# own (max, mean, loss rtol): twice the largest kernel - float64 reading over
# those seeds (4.02e-2, 7.40e-4, 1.59e-2), rounded up
PAC_TWIN_F64 = (8.1e-2, 1.5e-3, 3.2e-2)
# phase 11: MAML and the Neural Process on sin_20, as
# experiments/baselines/baseline_comparison.py runs them (the learners'
# defaults, 10,000 steps, eval on 50 test tasks); tools/maml_np_ref.py's
# learners. The band seeds take MAML_NP_BAND_STEPS steps (seed 30's metric
# read at that step of its full fit): the full fits of three seeds would take
# the phase past its share of the smoke's time
MAML_NP_STEPS, MAML_NP_STEADY, MAML_NP_TRACE = 10000, 500, 100
MAML_NP_BAND_STEPS = 2000
MAML_NP_SEEDS = (30, 31, 32)
MAML_NP_REF_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                                "maml_np_ref.json")
# written by tools/maml_np_band.py: the JAX learners on the CPU, seeds 30-59
MAML_NP_BAND_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                                 "maml_np_band.json")
# the image NP: synthetic 28 x 28 images in a gzipped IDX3 file, trained
# through mnist_image_batches with the defaults (r = z = h = 128)
NP_IMG_IMAGES, NP_IMG_BATCH, NP_IMG_EPOCHS = 64, 16, 2
# phase 12: the stacked fits. The meta-overfitting sweep's seeds
# (experiments/meta_overfitting/run_overfitting_sweep.py:25); 12a's stacked
# PACOH-SVGD fit of cauchy_20; 12b's PACOH-MAP cell on sin_32 through the
# 'vmap' route (its first SWEEP_VMAP_STEPS steps) and the 'sequential_fused'
# route (the sweep's SWEEP_FUSED_STEPS); 12c's trial groups and tune_run
SWEEP_SEEDS = (22, 23, 24, 25, 26)
SWEEP_STEPS = 500
SWEEP_VMAP_STEPS, SWEEP_FUSED_STEPS, SWEEP_TEST_TASKS = 1000, 10000, 50
TRIAL_STEPS, TUNE_STEPS, TUNE_BATCH = 500, 300, 4
# phase 14: the experiment CLIs at full width, their steps cut
CLI_STEPS, CLI_MLAP_META_TEST = 500, 100
CLI_SWEEP_STEPS, CLI_SEARCH_STEPS = 300, 200
CLI_KERNELS = {  # per-algorithm CLI -> (experiment name, the kernels its run must launch)
    "meta_gpr_mll_base_exp": ("meta_gpr_mll", ("fused_map",)),
    "meta_gpr_svgd_base_exp": ("meta_gpr_svgd", ("fused_svgd",)),
    "meta_gpr_vi_base_exp": ("meta_gpr_vi", ("fused_vi",)),
    "meta_mlap_base_exp": ("meta_mlap", ("fused_mlap",)),
    "maml_base_exp": ("maml", ()),
    "npr_base_exp": ("npr", ()),
}


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def median_ms(fn, reps):
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def time_pair(kernel, plain, reps=10):
    """Median ms of each, timed in turns: plain, kernel, kernel, plain."""
    import torch

    kernel(), plain()
    torch.cuda.synchronize()
    p = median_ms(plain, reps)
    k = median_ms(kernel, reps) + median_ms(kernel, reps)
    p += median_ms(plain, reps)
    return statistics.median(k), statistics.median(p)


def device_ms(fn, run=QUEUED_RUN):
    """ms a call of ``run`` calls queued behind a device-side wait
    (``torch.cuda._sleep``) long enough for the host to enqueue them all, so
    that the host's time is outside the event pair; and whether the host
    caught up all the same (a call that reads a value back to the host
    cannot be queued: its time then holds the host's)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(run):
        fn()
    torch.cuda.synchronize()
    enqueue_s = time.perf_counter() - t0
    for _ in range(3):
        torch.cuda._sleep(int(SLEEP_CYCLES_PER_S * (2.0 * enqueue_s + 2e-3)))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(run):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / run, False
        enqueue_s *= 2.0
    return start.elapsed_time(end) / run, True


def profiled_ms(fn, calls=PROFILED_CALLS):
    """Device ms a call: the durations of the kernels and copies that
    ``torch.profiler`` records on the card over ``calls`` calls, summed (the
    gaps between them left out), over ``calls``; None where it records
    none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # the card's own events only: a CPU op's device time repeats its kernels'
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False))
    return us / 1e3 / calls if us > 0 else None


def note_unqueued(key, fn, host):
    """Record how the time of ``key`` ("<kernel> plain" / "<kernel>
    library") was taken; a call that could not be queued waits in UNQUEUED
    for its kernels' sum."""
    TIMED_AS[key] = "host included" if host else "queued"
    if host:
        UNQUEUED[key] = fn


def device_pair(name, kernel, plain, walls, run=QUEUED_RUN):
    """Device ms a call of a kernel and of its plain version (``device_ms``),
    in turns: plain, kernel, kernel, plain, each the mean of its two runs;
    the kernel's single-call wall (one event pair around one synchronised
    call, median of 10) into ``walls[name]``; a plain version that could
    not be queued into UNQUEUED."""
    import torch

    kernel(), plain()
    torch.cuda.synchronize()
    p1, p1_host = device_ms(plain, run)
    k1, k_host = device_ms(kernel, run)
    k2, _ = device_ms(kernel, run)
    p2, p2_host = device_ms(plain, run)
    if k_host:
        raise AssertionError(f"{name}: the kernel's calls could not be queued ahead of the card")
    walls[name] = statistics.median(median_ms(kernel, 10))
    note_unqueued(f"{name} plain", plain, p1_host or p2_host)
    how = ("host included; its kernels' sum after the last phase" if p1_host or p2_host
           else "queued")
    print(f"  {name}: device {k1:.5f} / {k2:.5f} ms a call over {run} queued calls, plain "
          f"{p1:.5f} / {p2:.5f} ({how}); single-call wall {walls[name]:.5f} ms")
    return 0.5 * (k1 + k2), 0.5 * (p1 + p2)


def library_time(name, fn, run=QUEUED_RUN):
    """Device ms a call of a kernel's library yardstick (``device_ms``),
    into UNQUEUED if it could not be queued."""
    ms, host = device_ms(fn, run)
    note_unqueued(f"{name} library", fn, host)
    return ms


def settle_kernel_sums(times, library):
    """Replace each recorded plain version's and library call's time that
    holds host time (UNQUEUED) by the sum of its kernels' device times
    (``profiled_ms``, up to three tries), now that no phase is left for a
    profiler session to slow."""
    for key, fn in UNQUEUED.items():
        name, what = key.rsplit(" ", 1)
        b1 = name[:-len(" at B=1")] if name.endswith(" at B=1") else None
        if name not in times and b1 not in ONE_SYSTEM:  # a shape printed, not recorded
            continue
        for _ in range(3):
            summed = profiled_ms(fn)
            if summed is not None:
                break
        if summed is None:
            print(f"  {key}: torch.profiler recorded no device time; host time stays included")
            continue
        if b1 in ONE_SYSTEM:
            ONE_SYSTEM[b1][f"{what}_ms"] = summed
        elif what == "plain":
            times[name] = (times[name][0], summed)
        else:
            library[name] = summed
        TIMED_AS[key] = "kernel sum"
        print(f"  {key}: {summed:.5f} ms a call, the sum of its kernels' device times")


def system_err(got, want):
    """(max abs error, max per-system error / max |want| of that system)."""
    import torch

    diff = (got - want).abs().reshape(got.shape[0], -1)
    scale = want.abs().reshape(want.shape[0], -1).amax(dim=1).clamp_min(1e-30)
    return float(diff.max()), float((diff.amax(dim=1) / scale).max())


def check(name, got, want, records):
    abs_err, rel = system_err(got, want)
    print(f"  {name}: max abs err {abs_err:.3e}, max per-system rel err {rel:.3e}")
    if not rel <= KERNEL_RTOL:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"({rel:.3e} > {KERNEL_RTOL})")
    records[name] = max(records.get(name, 0.0), abs_err)


def spd(n_sys, n, gen, scale=0.1):
    import torch

    g = torch.randn(n_sys, n, n + 3, generator=gen).cuda()
    return (g @ g.mT / n + scale * torch.eye(n, device="cuda")).contiguous()


def escalating_systems(n, gen, lam_min):
    """A symmetric matrix with eigenvalues in [1e-4, 1e-3] except one lam_min."""
    import torch

    q, _ = torch.linalg.qr(torch.randn(n, n, generator=gen, dtype=torch.float64))
    lam = torch.empty(n, dtype=torch.float64).uniform_(1e-4, 1e-3, generator=gen)
    lam[0] = lam_min
    return ((q * lam) @ q.T).float().cuda()


def mlp_flops(rows, d, hidden, out):
    """Flops of a tanh MLP's forward, weight gradients and input gradients
    (none into the data) over ``rows`` rows."""
    sizes = [d, *hidden, out]
    macs = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    return 2 * rows * (3 * macs - d * hidden[0])


def gp_task_flops(n, f):
    """About the flops of one task's MLL and its gradient: the kernel matrix,
    one factorization, the solves, L^-1, K^-1 and the gradient's pair terms."""
    return n * n * (3 * f + 10) + n ** 3


def phase2(param_dim):
    import torch

    from meta_learning_pacoh_torch.ops.cuda import chol_kernel, mll_kernel, svgd_kernel

    gen = torch.Generator().manual_seed(0)
    # work[name] = (flops, bytes) of one timed call (B2, B6: of one step);
    # library[name] = ms of one PyTorch call computing the same function;
    # walls[name] = a pure kernel's single-call wall
    errs, times, work, library, walls = {}, {}, {}, {}, {}

    phase2_general(param_dim, gen, errs, times, work, library, walls)

    # K4 at the eval's shape: 200 test tasks x 10 particles of N = 200, with
    # one indefinite matrix that must come back NaN as in the plain version
    a = spd(2000, 200, gen)
    lam = torch.linalg.eigvalsh(a[5])
    a[5] -= (lam[0] + 0.05 * (lam[1] - lam[0])) * torch.eye(200, device="cuda")
    a[5] -= 1e-3 * torch.eye(200, device="cuda")
    got, want = chol_kernel.cholesky_fused(a), chol_kernel.cholesky_ref(a)
    nan_got, nan_want = torch.isnan(got), torch.isnan(want)
    if not (torch.equal(nan_got, nan_want) and bool(nan_want[5].all())
            and not bool(nan_want[torch.arange(2000) != 5].any())):
        raise AssertionError("chol: NaN pattern differs from the plain version")
    keep = torch.arange(2000, device="cuda") != 5
    check("chol", got[keep], want[keep], errs)
    # the tiles' and the shared-memory edges, each batch with one indefinite matrix
    for n in K4_EDGES:
        e = spd(8, n, gen)
        e[3] -= 10.0 * torch.eye(n, device="cuda")
        got, want = chol_kernel.cholesky_fused(e), chol_kernel.cholesky_ref(e)
        if not (torch.equal(torch.isnan(got), torch.isnan(want)) and bool(torch.isnan(got[3]).all())):
            raise AssertionError(f"chol: NaN pattern differs from the plain version at N={n}")
        where = "shared" if chol_kernel.chol_in_shared(n) else "device"
        print(f"  chol at N={n} (the matrix in {where} memory):")
        check("chol", got[torch.arange(8) != 3], want[torch.arange(8) != 3], errs)
    print(f"  chol: {chol_kernel.chol_blocks_per_sm(200)} resident blocks per SM at N=200")
    # the evals' batches: cauchy_20 and vi_t5_n200 (B=2000), svgd_t5_n200 and
    # map_t5_n200 (B=200)
    a200 = a[:200].clone()
    k_ms, p_ms = device_pair("chol at B=200", lambda: chol_kernel.cholesky_fused(a200),
                             lambda: chol_kernel.cholesky_ref(a200), walls)
    lib_ms = device_ms(lambda: torch.linalg.cholesky_ex(a200))[0]
    print(f"  chol at B=200, N=200: kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms, "
          f"torch.linalg.cholesky_ex {lib_ms:.5f} ms (device)")
    times["chol"] = device_pair("chol", lambda: chol_kernel.cholesky_fused(a),
                                lambda: chol_kernel.cholesky_ref(a), walls, run=20)
    # in: the lower triangle of each matrix (all the kernel reads); out: the square
    work["chol"] = (2000 * 200 ** 3 / 3, 4 * 2000 * (200 * 201 // 2 + 200 * 200))
    library["chol"] = library_time("chol", lambda: torch.linalg.cholesky_ex(a), run=20)
    phase2_b2(errs, times, work)
    phase2_b6(errs, times, work)
    phase2_b7(errs, times, work)
    phase2_b4(errs, times, work, library, walls)
    phase2_b9(errs, times, work)
    phase2_b5(errs, times, work, library, walls)
    phase2_b8(errs, times, work)
    phase2_b10(errs, times, work)
    phase2_b11(errs, times, work)
    phase2_b1(errs, walls)
    bign_escalation()
    phase2_many_tasks(errs)
    for name, (k_ms, p_ms) in times.items():
        unit = "ms a step" if name.startswith("fused") else "ms"
        call = ("torch.cholesky_inverse" if name in ("blocked_bwd", "mll_bwd")
                else "torch.linalg.cholesky_ex")
        lib = (f", {call} {library[name]:.5f} ms ({TIMED_AS[f'{name} library']})"
               if name in library else "")
        how = (f"device time, queued; plain: {TIMED_AS[f'{name} plain']}; single-call wall "
               f"{walls[name]:.5f} ms" if name in walls else "median of single calls")
        print(f"  {name}: kernel {k_ms:.5f} {unit}, plain {p_ms:.5f} {unit} ({how}){lib}")
    return errs, times, work, library


def svgd_phi_exact(x, s):
    """The plain transport on squared distances summed from differences, as
    K1 forms them: at K=1 the expansion |a|^2 + |b|^2 - 2ab leaves rounding
    noise on the diagonal, and that noise is the median that sets the
    bandwidth; the kernel's diagonal is exactly 0 (phi = score)."""
    import torch

    from meta_learning_pacoh_torch.ops.cuda import svgd_kernel

    k = x.shape[0]
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    gamma = 1.0 / (1e-8 + 2.0 * svgd_kernel.median_upper(d2) / (2.0 * math.log(k + 1)))
    k_xx = torch.exp(-gamma * d2)
    return (k_xx @ s + 2.0 * gamma * (x * k_xx.sum(1, keepdim=True) - k_xx @ x)) / k


def report_usage(label, entry, usage_entry, instance):
    """Print a kernel instance's registers and local memory a thread as the
    card reports them (``build.kernel_usage`` through C entry
    ``usage_entry``), whichever run built the library, and ptxas' spills
    where this run built it; raise if the kernel uses local memory (spills
    or a stack frame), which a design that keeps its rows in registers must
    not."""
    from meta_learning_pacoh_torch.ops.cuda import build

    regs, local = build.kernel_usage(usage_entry, instance)
    usage = ptxas_usage(entry)
    spills = (f"ptxas spill stores/loads {usage[1]} bytes" if usage is not None
              else "no ptxas log: library from an earlier build")
    print(f"  {label}: {regs} registers, {local} bytes of local memory a thread ({spills})")
    if local != 0 or (usage is not None and usage[1] != (0, 0)):
        raise AssertionError(f"{label} uses local memory: {local} bytes a thread, {spills}")


def phase2_general(param_dim, gen, errs, times, work, library, walls):
    """K1-K3, the general step's kernels, against their plain versions:
    K1 at the slice's [10, P] and at the SE learner's [10, 1188], at K=1
    (exact distances) and K=32 (also at P=20000, its slices read from device
    memory), at a ragged P and at P smaller than one CTA's slice, two calls
    bit for bit; K2 on escalating systems at N=20 (B=200, 1, 7 and 1000)
    and at N in {32, 33, 48 (B=50 and 200), 64}, each batch with a system
    that fails at every jitter level (non-finite where the plain version
    is); K3 on the plain version's L and z and on K2's own, its dKn exactly
    symmetric. Every kernel instance's registers and local memory. Times at
    the slice's shapes as device time (``device_pair``), with the library
    calls."""
    import torch

    from meta_learning_pacoh_torch.ops.cuda import chol_kernel, mll_kernel, svgd_kernel

    for label, k, p in (("the slice's", 10, param_dim), ("the SE learner's", 10, 1188)):
        plan = svgd_kernel.svgd_plan(k, p)
        print(f"  svgd_phi plan at {label} [{k}, {p}]: {plan}")
        if plan.cluster < 2:
            raise AssertionError(f"svgd_phi: one CTA at {label} [{k}, {p}]")
    report_usage("svgd_phi (P staged)", "svgd_phi_cluster_kernelILb1", "pacoh_svgd_phi_usage", 1)
    report_usage("svgd_phi (P in device memory)", "svgd_phi_cluster_kernelILb0",
                 "pacoh_svgd_phi_usage", 0)
    for k, p, cluster in ((10, param_dim, None), (10, 1188, None), (1, param_dim, None),
                          (32, param_dim, None), (32, 20000, None), (10, 2371, None),
                          (10, 37, None), (10, 3, 16)):
        x = torch.randn(k, p, generator=gen).cuda()
        s = 10.0 * torch.randn(k, p, generator=gen).cuda()
        got = svgd_kernel.svgd_phi_fused(x, s, cluster=cluster)
        plain = svgd_phi_exact if k == 1 else svgd_kernel.svgd_phi_ref
        print(f"  svgd_phi at [{k}, {p}], plan {svgd_kernel.svgd_plan(k, p, cluster)}:")
        check("svgd_phi", got[None], plain(x, s)[None], errs)
        if k == 10 and p == param_dim:
            if not torch.equal(got, svgd_kernel.svgd_phi_fused(x, s)):
                raise AssertionError("svgd_phi: two calls differ")
            print("    two calls give the same bits")
            x_main, s_main = x, s
    times["svgd_phi"] = device_pair("svgd_phi", lambda: svgd_kernel.svgd_phi_fused(x_main, s_main),
                                    lambda: svgd_kernel.svgd_phi_ref(x_main, s_main), walls)
    # distances, the kernel row sums and two K x K by K x P products
    work["svgd_phi"] = (7 * 10 * 10 * param_dim, 4 * 3 * 10 * param_dim)
    phase2_k1_seeds(x_main, s_main, gen, errs, times, work, walls)

    report_usage("mll_fwd (N <= 32)", "mll_fwd_warp_kernelILi1", "pacoh_mll_fwd_usage", 0)
    report_usage("mll_fwd (33 <= N <= 64)", "mll_fwd_warp_kernelILi2", "pacoh_mll_fwd_usage", 1)
    report_usage("mll_bwd (N <= 32)", "mll_bwd_warp_kernelILi1", "pacoh_mll_bwd_usage", 0)
    report_usage("mll_bwd (33 <= N <= 64)", "mll_bwd_warp_kernelILi2", "pacoh_mll_bwd_usage", 1)

    def systems(b, n, esc, fail):
        """b SPD systems of size n; at esc (index, lam_min) pairs a system
        needing the 1e-4 (lam_min -5e-5) or the 1e-2 jitter (-5e-3); at the
        indices in fail one indefinite at every level."""
        kn = spd(b, n, gen, scale=0.5)
        for i, lam_min in esc:
            kn[i] = escalating_systems(n, gen, lam_min)
        for i in fail:
            kn[i] -= 10.0 * torch.eye(n, device="cuda")
        return kn, torch.randn(b, n, generator=gen).cuda()

    esc5 = ((3, -5e-5), (50, -5e-5), (120, -5e-5), (7, -5e-3), (160, -5e-3))
    for b, n, esc, fail in ((200, 20, esc5, ()), (200, 20, esc5[:2], (11,)), (1, 20, (), ()),
                            (1000, 20, esc5, (999,)), (7, 20, ((2, -5e-5), (4, -5e-3)), (5,)),
                            (200, 32, esc5[:2], (11,)), (200, 33, esc5[:2], (11,)),
                            (50, 48, ((3, -5e-5), (7, -5e-3)), (11,)),
                            (200, 48, esc5[:2], (11,)), (200, 64, esc5[:2], (11,))):
        kn, r = systems(b, n, esc, fail)
        eye = torch.eye(n, device="cuda")
        ok = [chol_kernel.diag_ok(chol_kernel.cholesky_ref(kn + j * eye))
              for j in mll_kernel.JITTERS]
        level = torch.where(ok[0], 0, torch.where(ok[1], 1, 2))
        if b == 200 and n == 20 and not fail and not {0, 1, 2} <= set(level.tolist()):
            raise AssertionError(f"escalation levels hit: {sorted(set(level.tolist()))}")
        got = mll_kernel.mll_fwd(kn, r)
        want = mll_kernel.mll_fwd_ref(kn, r)
        print(f"  mll_fwd at B={b}, N={n}, levels {sorted(set(level.tolist()))}, "
              f"{len(fail)} failing at every level:")
        keep = torch.ones(b, dtype=torch.bool, device="cuda")
        keep[list(fail)] = False
        for g_, w_ in zip(got[:2], want[:2]):
            if not torch.equal(torch.isfinite(g_), torch.isfinite(w_)):
                raise AssertionError("mll_fwd: quad or logdet finite where the plain version's "
                                     "is not, or the other way")
        for label, g_, w_ in zip(("quad", "logdet", "L", "z"), got, want):
            check("mll_fwd", g_[keep].reshape(int(keep.sum()), -1),
                  w_[keep].reshape(int(keep.sum()), -1), errs)
            print(f"    ({label})")
        gq = torch.randn(b, generator=gen).cuda()
        gl = torch.randn(b, generator=gen).cuda()
        for source, (_, _, L, z) in (("the plain version's", want), ("K2's own", got)):
            L, z = L[keep].contiguous(), z[keep].contiguous()
            got_bwd = mll_kernel.mll_bwd(L, z, gq[keep], gl[keep])
            for label, g_, w_ in zip(("dkn", "dr"), got_bwd,
                                     mll_kernel.mll_bwd_ref(L, z, gq[keep], gl[keep])):
                check("mll_bwd", g_, w_, errs)
                print(f"    (K3 {label} on {source} L and z)")
            if not torch.equal(got_bwd[0], got_bwd[0].mT):
                raise AssertionError("mll_bwd: dKn is not exactly symmetric")
        if b == 200 and n == 20 and not fail:  # the slice's shape: timed
            timed = (kn, r, want[2], want[3], gq, gl)
    kn, r, L, z, gq, gl = timed
    b, n = kn.shape[0], kn.shape[-1]
    times["mll_fwd"] = device_pair("mll_fwd", lambda: mll_kernel.mll_fwd(kn, r),
                                   lambda: mll_kernel.mll_fwd_ref(kn, r), walls)
    times["mll_bwd"] = device_pair("mll_bwd", lambda: mll_kernel.mll_bwd(L, z, gq, gl),
                                   lambda: mll_kernel.mll_bwd_ref(L, z, gq, gl), walls)
    # the yardsticks: the factor alone (K2), K^-1 alone from L (K3)
    library["mll_fwd"] = library_time("mll_fwd", lambda: torch.linalg.cholesky_ex(kn))
    library["mll_bwd"] = library_time("mll_bwd", lambda: torch.cholesky_inverse(L))
    # one factorization a system per jitter level it needed, the solve, quad
    # and logdet; in: Kn, r; out: quad, logdet, L, z (the backward's in and
    # out have the same size: L, z, gq, gl; dKn, dr)
    eye = torch.eye(n, device="cuda")
    ok = [chol_kernel.diag_ok(chol_kernel.cholesky_ref(kn + j * eye)) for j in mll_kernel.JITTERS]
    level = torch.where(ok[0], 0, torch.where(ok[1], 1, 2))
    n_fact = float((level + 1).sum())
    mll_bytes = 4 * (2 * b * n * n + 2 * b * n + 2 * b)
    work["mll_fwd"] = (n_fact * n ** 3 / 3 + b * (n * n + 3 * n), mll_bytes)
    work["mll_bwd"] = (b * (2 * n ** 3 / 3 + 3 * n * n), mll_bytes)


def phase2_k1_seeds(x_main, s_main, gen, errs, times, work, walls):
    """K1's seed axis: at S=1 the bits of the [K, P] call; at the stacked
    fits' shapes of phase 12 (K1_SEED_ROWS) against the batched plain
    version, each system its own median, one launch a call, and timed as
    device time."""
    import torch

    from meta_learning_pacoh_torch.ops import cuda
    from meta_learning_pacoh_torch.ops.cuda import svgd_kernel

    one = svgd_kernel.svgd_phi_fused(x_main[None].contiguous(), s_main[None].contiguous())
    if not torch.equal(one[0], svgd_kernel.svgd_phi_fused(x_main, s_main)):
        raise AssertionError("svgd_phi: [1, K, P] differs from the [K, P] call")
    print(f"  svgd_phi at [1, {x_main.shape[0]}, {x_main.shape[1]}]: the bits of the [K, P] call")
    for name, (n_sys, k, p) in K1_SEED_ROWS.items():
        x = torch.randn(n_sys, k, p, generator=gen).cuda()
        s = 10.0 * torch.randn(n_sys, k, p, generator=gen).cuda()
        x[-1] *= 3.0  # a system of another scale: its own median
        before = cuda.LAUNCHES["svgd_phi"]
        got = svgd_kernel.svgd_phi_fused(x, s)
        if cuda.LAUNCHES["svgd_phi"] != before + 1:
            raise AssertionError(f"{name}: not one launch a call")
        print(f"  {name}, one launch of {n_sys} clusters of {svgd_kernel.svgd_plan(k, p).cluster}:")
        check(name, got, svgd_kernel.svgd_phi_ref(x, s), errs)
        times[name] = device_pair(name, lambda x=x, s=s: svgd_kernel.svgd_phi_fused(x, s),
                                  lambda x=x, s=s: svgd_kernel.svgd_phi_ref(x, s), walls)
        work[name] = (7 * n_sys * k * k * p, 4 * 3 * n_sys * k * p)


def sin20():
    import numpy as np

    from meta_learning_pacoh_torch.datasets import SinusoidDataset

    env = SinusoidDataset(random_state=np.random.RandomState(26))
    train = env.generate_meta_train_data(n_tasks=20, n_samples=5)
    test = env.generate_meta_test_data(n_tasks=20, n_samples_context=5, n_samples_test=50)
    return train, test


def sin20_model(train, seed=30, **kw):
    """bench.py's sin_20 SVGD learner, on the card by default."""
    from meta_learning_pacoh_torch import GPRegressionMetaLearnedSVGD

    kw = {"task_batch_size": -1, **kw}
    return GPRegressionMetaLearnedSVGD(train, num_iter_fit=SIN_STEPS, num_particles=10,
                                       random_seed=seed, prior_factor=0.01, **kw)


def ptxas_usage(entry):
    """(registers, (spill stores, spill loads) in bytes) of the kernel whose
    name holds ``entry``, from nvcc's -Xptxas -v log of this run's build;
    None when the library was built by an earlier run."""
    from meta_learning_pacoh_torch.ops.cuda import build

    lines = build.build_info.get("log", "").splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and entry in line:
            spills = None
            for nxt in lines[i + 1:i + 5]:
                found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", nxt)
                if found and spills is None:
                    spills = (int(found.group(1)), int(found.group(2)))
                found = re.search(r"Used (\d+) registers", nxt)
                if found:
                    return int(found.group(1)), spills
    return None


def cluster_report(kernel, count, t, n, d, hidden):
    """Print the cluster plan of B2 (``fused_svgd``, K = count), B7
    (``fused_vi``, S = count) or B8 (``fused_mlap``, S = count) at these
    shapes: its cluster size C, its CTAs, the clusters of C the card holds
    at once (cudaOccupancyMaxActiveClusters) and CTAs an SM so, ptxas'
    registers and spills. Raises if the card cannot hold every cluster.
    Returns the plan."""
    import torch

    from meta_learning_pacoh_torch.ops.cuda import fused_mlap_kernel as mk
    from meta_learning_pacoh_torch.ops.cuda import fused_svgd_kernel as fk
    from meta_learning_pacoh_torch.ops.cuda import fused_vi_kernel as vk

    if kernel == "fused_svgd":
        plan = fk.cluster_plan(count, t, n, d, hidden)
        resident = fk.resident_clusters(count, t, n, d, hidden, plan)
    else:
        module = vk if kernel == "fused_vi" else mk
        plan = module.cluster_plan(count, t, n, d, hidden)
        resident = module.resident_clusters(t, n, d, hidden, plan)
    c, sms = plan[0], torch.cuda.get_device_properties(0).multi_processor_count
    entry = f"{kernel}_kernelILi{n}E"  # the kernel instance of N
    if kernel == "fused_mlap":  # and, of B8, untiled or tiled
        entry += f"Lb{int(plan[-1] < -(-t // c))}E"
    usage = ptxas_usage(entry)
    ptxas = ("not in this run's build log" if usage is None else
             f"{usage[0]} registers a thread, spill stores/loads {usage[1]} bytes")
    print(f"  {kernel} at {'K' if kernel == 'fused_svgd' else 'S'}={count}, T={t}, N={n}, D={d}, "
          f"hidden {hidden}: plan {plan}, clusters of {c} CTAs, {count * c} CTAs on {sms} SMs; "
          f"the card holds {resident} such clusters at once ({resident * c / sms:.2f} CTAs an "
          f"SM); ptxas: {ptxas}")
    if resident < count:
        raise AssertionError(f"{kernel}: the card holds {resident} clusters of {c}, not {count}")
    return plan


def phase2_b2(errs, times, work):
    """B2 against its plain version at sin_20's shapes, from one state; its
    cluster plans and time a step at K=10 and K=32."""
    import numpy as np
    import torch

    from meta_learning_pacoh_torch.ops import launch_sched
    from meta_learning_pacoh_torch.ops.cuda import fused_svgd_kernel as fk

    train, _ = sin20()
    cases = (("full batch", {}, B2_STEPS),
             ("sampled batch of 5", {"task_batch_size": 5}, B2_STEPS),
             ("staircase lr_decay 0.5", {"lr_decay": 0.5}, B2_STAIR_STEPS))
    transition = launch_sched.LR_TRANSITION_STEPS
    for label, kw, n_steps in cases:
        model = sin20_model(train, **kw)
        launch_sched.LR_TRANSITION_STEPS = B2_STAIR_TRANSITION
        try:
            trainer = fk.FusedSVGDTrainer(
                model.X, model.Y, model.mask, hidden=(32, 32), lr=1e-3, prior_factor=0.01,
                weight_prior_std=0.5, bias_prior_std=3.0, lr_decay=kw.get("lr_decay", 1.0),
                task_batch_size=model.task_batch_size, task_draw=model._task_draw)
            got = [model.particles.clone(), torch.zeros_like(model.particles),
                   torch.zeros_like(model.particles)]
            want = [t.clone() for t in got]
            trainer.run(*got, n_steps, 0)
            for s0, sub in trainer.launches(0, n_steps):
                counts = trainer.count_pages(s0, sub) if trainer.counted else None
                fk.fused_svgd_train_ref(
                    *want, model.X, model.Y, model.mask, trainer.w_t, s0,
                    launch_sched.staircase_lr(1e-3, trainer.lr_decay, s0), 0.01, counts,
                    hidden=(32, 32), wps=0.5, bps=3.0, n_steps=sub)
        finally:
            launch_sched.LR_TRANSITION_STEPS = transition
        torch.cuda.synchronize()
        skip = model.hyper_prior.slice_of(("kernel_nn", "b_out"))
        d_max, d_mean = diff_excluding(got[0].cpu(), want[0].cpu(), skip)
        rel = [diff_excluding(g.cpu(), w.cpu(), skip)[0] / float(w.abs().max())
               for g, w in zip(got[1:], want[1:])]
        print(f"  fused_svgd, {label}, {n_steps} steps: |particle diff| max {d_max:.3e}, "
              f"mean {d_mean:.3e}; Adam m, v max diff / max |plain| {rel[0]:.3e}, "
              f"{rel[1]:.3e} (kernel_nn.b_out excluded)")
        if not (d_max <= TWIN_ATOL and d_mean <= TWIN_MEAN_ATOL
                and max(rel) <= B2_MOMENT_RTOL):
            raise AssertionError(f"fused_svgd ({label}): kernel disagrees with its plain version")
        errs["fused_svgd"] = max(errs.get("fused_svgd", 0.0), d_max)

    # per step: the kernel over launches of 200 steps, the plain version over 5
    model = sin20_model(train)
    trainer = fk.FusedSVGDTrainer(model.X, model.Y, model.mask, hidden=(32, 32), lr=1e-3,
                                  prior_factor=0.01, weight_prior_std=0.5,
                                  bias_prior_std=3.0)
    k_state = [model.particles.clone(), torch.zeros_like(model.particles),
               torch.zeros_like(model.particles)]
    p_state = [t.clone() for t in k_state]
    k_ms, p_ms = time_pair(
        lambda: trainer.run(*k_state, 200, 0),
        lambda: fk.fused_svgd_train_ref(*p_state, model.X, model.Y, model.mask, trainer.w_t,
                                        0, 1e-3, 0.01, hidden=(32, 32), wps=0.5, bps=3.0,
                                        n_steps=5),
        reps=3)
    times["fused_svgd"] = (k_ms / 200, p_ms / 5)
    k, p, (t, n, d) = 10, model.hyper_prior.dim, model.X.shape
    cluster_report("fused_svgd", k, t, n, d, (32, 32))
    # the window's largest K at sin_20's tasks: clusters of fewer CTAs
    rs = np.random.RandomState(32)
    hp = model.hyper_prior
    wide = hp.loc + hp.scale * torch.from_numpy(rs.randn(32, p).astype(np.float32)).cuda()
    wide_state = [wide, torch.zeros_like(wide), torch.zeros_like(wide)]
    cluster_report("fused_svgd", 32, t, n, d, (32, 32))
    wide_ms = statistics.median(median_ms(lambda: fk.fused_svgd_train(
        *wide_state, model.X, model.Y, model.mask, trainer.w_t, 0, 1e-3, 0.01, hidden=(32, 32),
        wps=0.5, bps=3.0, n_steps=200), 3)) / 200
    print(f"  fused_svgd at K=32: {wide_ms:.4f} ms a step (launches of 200 steps)")
    step_flops = (k * (2 * mlp_flops(t * n, d, (32, 32), 1) + t * gp_task_flops(n, 1))
                  + 7 * k * k * p + 12 * k * p)
    # a launch of 200 steps reads and writes theta, m, v once, reads the data once
    work["fused_svgd"] = (step_flops, 4 * (6 * k * p + t * n * (d + 2) + t) / 200)


def demo_model(tasks, seed=30, **kw):
    """The reference demo's learner (demo.py:17-21), on the card by default."""
    from meta_learning_pacoh_torch import GPRegressionMetaLearned

    return GPRegressionMetaLearned(tasks, weight_decay=0.2, num_iter_fit=MAP_STEPS,
                                   random_seed=seed, **kw)


def phase2_b6(errs, times, work):
    """B6 against its plain version at the demo's shapes and one odd shape,
    from the learner's initial state."""
    import numpy as np
    import torch

    from meta_learning_pacoh_torch.models.random_gp import layout_slice
    from meta_learning_pacoh_torch.ops import launch_sched
    from meta_learning_pacoh_torch.ops.cuda import fused_map_kernel as mk

    train, _ = sin20()
    rs = np.random.RandomState(7)  # 7 tasks of up to 8 points, D=3, padded by the learner
    odd = [(rs.uniform(-2.0, 2.0, (m, 3)), rs.randn(m)) for m in (8, 5, 8, 3, 7, 8, 1)]
    odd_kw = dict(task_batch_size=-1, feature_dim=3, mean_nn_layers=(16, 16, 16),
                  kernel_nn_layers=(32, 32))
    many = [(rs.uniform(-2.0, 2.0, (8, 1)), rs.randn(8)) for _ in range(1000)]
    cases = (("full batch", train, {"task_batch_size": -1}, B6_STEPS),
             ("sampled batch of 5", train, {}, B6_STEPS),
             ("staircase lr_decay 0.5", train, {"task_batch_size": -1, "lr_decay": 0.5},
              B6_STAIR_STEPS),
             ("7 ragged tasks, D=3, F=3, nets (16,16,16)/(32,32)", odd, odd_kw, B6_STEPS),
             ("nets (7,7): the scalar passes", train,
              dict(mean_nn_layers=(7, 7), kernel_nn_layers=(7, 7)), B6_STEPS),
             ("200 tasks, sampled batch of 37", faceoff_tasks(200, 5),
              dict(task_batch_size=37), B6_STEPS),
             ("1000 tasks of 8 points: the cooperative grid", many, {"task_batch_size": 50},
              B6_STEPS))
    transition = launch_sched.LR_TRANSITION_STEPS
    for label, tasks, kw, n_steps in cases:
        model = demo_model(tasks, **kw)
        t, n, d = model.X.shape
        c, tiled = mk.map_plan(t, n, d, model.cfg.feature_dim, model.cfg.mean_nn_layers,
                               model.cfg.kernel_nn_layers)
        label += (f" (a cluster of {c} CTAs" if c else f" ({mk.task_groups(t)[0]} blocks") + \
            f", {'tiled' if tiled else 'scalar'} nets)"
        launch_sched.LR_TRANSITION_STEPS = B2_STAIR_TRANSITION
        try:
            trainer = model._fused_trainer()
            got = [model.params.clone(), torch.zeros_like(model.params),
                   torch.zeros_like(model.params)]
            want = [t.clone() for t in got]
            got_loss, _ = trainer.run(*got, n_steps, 0)
            for s0, sub in trainer.launches(0, n_steps):
                counts = trainer.count_pages(s0, sub) if trainer.counted else None
                want_loss, _ = mk.fused_map_train_ref(
                    *want, model.X, model.Y, model.mask, trainer.w_t, s0,
                    launch_sched.staircase_lr(1e-3, trainer.lr_decay, s0), 0.2, counts,
                    layout=model.layout, n_steps=sub)
        finally:
            launch_sched.LR_TRANSITION_STEPS = transition
        torch.cuda.synchronize()
        skip = layout_slice(model.layout, ("kernel_nn", "b_out"))
        d_max, d_mean = diff_excluding(got[0].cpu(), want[0].cpu(), skip)
        rel = [diff_excluding(g.cpu(), w.cpu(), skip)[0] / float(w.abs().max())
               for g, w in zip(got[1:], want[1:])]
        loss_rel = abs(float(got_loss) - float(want_loss)) / abs(float(want_loss))
        print(f"  fused_map, {label}, {n_steps} steps: |param diff| max {d_max:.3e}, "
              f"mean {d_mean:.3e}; AdamW m, v max diff / max |plain| {rel[0]:.3e}, "
              f"{rel[1]:.3e}; last loss rel diff {loss_rel:.3e} (kernel_nn.b_out excluded)")
        if not (d_max <= TWIN_ATOL and d_mean <= TWIN_MEAN_ATOL
                and max(rel) <= B2_MOMENT_RTOL and loss_rel <= B6_LOSS_RTOL):
            raise AssertionError(f"fused_map ({label}): kernel disagrees with its plain version")
        errs["fused_map"] = max(errs.get("fused_map", 0.0), d_max)

    # per step at the main path's launch: a sampled batch of 5, 512 steps a
    # launch from prebuilt count pages; the plain version over 5 steps
    model = demo_model(train)
    trainer = model._fused_trainer()
    counts = trainer.count_pages(0, mk.FusedMAPTrainer.MAX_LAUNCH)
    data = (model.X, model.Y, model.mask, trainer.w_t)
    k_state = [model.params.clone(), torch.zeros_like(model.params),
               torch.zeros_like(model.params)]
    p_state = [t.clone() for t in k_state]
    k_ms, p_ms = time_pair(
        lambda: mk.fused_map_train(*k_state, *data, 0, 1e-3, 0.2, counts, layout=model.layout,
                                   n_steps=counts.shape[0]),
        lambda: mk.fused_map_train_ref(*p_state, *data, 0, 1e-3, 0.2, counts[:5],
                                       layout=model.layout, n_steps=5),
        reps=3)
    times["fused_map"] = (k_ms / counts.shape[0], p_ms / 5)
    full_ms = statistics.median(median_ms(
        lambda: mk.fused_map_train(*k_state, *data, 0, 1e-3, 0.2, layout=model.layout,
                                   n_steps=200), 3)) / 200
    print(f"  fused_map, full batch: kernel {full_ms:.4f} ms a step (launches of 200 steps); "
          f"plan (C, tiled) {mk.map_plan(*model.X.shape, 2, (32, 32), (32, 32))}; ptxas "
          f"{ptxas_usage('fused_map_cluster_kernel')} (registers, spill stores and loads)")
    # the function needs only the rows of the tasks each step draws (an
    # undrawn task adds exactly 0): both nets' forward and backward over
    # them, their MLLs, and AdamW; as a mean over the launch's count pages
    p, (t, n, d) = model.params.numel(), model.X.shape
    drawn = (counts > 0).float()
    rows = float((drawn @ model.mask.sum(dim=1)).mean())
    step_flops = (mlp_flops(rows, d, (32, 32), 1) + mlp_flops(rows, d, (32, 32), 2)
                  + float(drawn.sum(dim=1).mean()) * gp_task_flops(n, 2) + 12 * p)
    print(f"  fused_map, the timed launch: {rows / n:.2f} of {t} tasks drawn a step on average, "
          f"{step_flops:.0f} flops a step")
    n_launch = counts.shape[0]  # a launch reads and writes theta, m, v once, reads the data once
    work["fused_map"] = (step_flops,
                         4 * (6 * p + t * n * (d + 2) + t + n_launch * t) / n_launch)


def vi_model(tasks, seed=30, **kw):
    """The sin_20 VI fit's learner (the JAX learner's defaults), on the card by default."""
    from meta_learning_pacoh_torch import GPRegressionMetaLearnedVI

    return GPRegressionMetaLearnedVI(tasks, num_iter_fit=VI_STEPS, random_seed=seed, **kw)


def vi_trainer(model):
    from meta_learning_pacoh_torch.ops.cuda.fused_vi_kernel import FusedVITrainer

    return FusedVITrainer(model.X, model.Y, model.mask, hidden=tuple(model.cfg.mean_nn_layers),
                          lr=model._lr, prior_factor=model.prior_factor,
                          weight_prior_std=model._weight_prior_std,
                          bias_prior_std=model._bias_prior_std,
                          svi_batch_size=model.svi_batch_size, eps_draw=model._draw_eps,
                          lr_decay=model._lr_decay, task_batch_size=model.task_batch_size,
                          task_draw=model._task_draw)


def vi_state(model):
    """Copies of the learner's loc, log_scale and their Adam moments."""
    return [tree[k].clone() for tree in (model.posterior, model._mu, model._nu)
            for k in ("loc", "log_scale")]


def phase2_b7(errs, times, work):
    """B7 against its plain version at the sin_20 VI fit's shapes and one odd
    shape, from the learner's initial state, with the learner's own noise."""
    import numpy as np
    import torch

    from meta_learning_pacoh_torch.ops import launch_sched
    from meta_learning_pacoh_torch.ops.cuda import fused_vi_kernel as vk

    train, _ = sin20()
    rs = np.random.RandomState(11)  # 7 tasks of up to 7 points, D=2, padded by the learner
    odd = [(rs.uniform(-2.0, 2.0, (m, 2)), rs.randn(m)) for m in (7, 5, 7, 3, 7, 6, 1)]
    odd_kw = dict(svi_batch_size=3, mean_nn_layers=(16, 16, 16), kernel_nn_layers=(16, 16, 16))
    cases = (("full batch", train, {}, B7_STEPS),
             ("sampled batch of 5", train, {"task_batch_size": 5}, B7_STEPS),
             ("staircase lr_decay 0.5", train, {"lr_decay": 0.5}, B2_STAIR_STEPS),
             ("S=3, 7 ragged tasks of up to 7 points, D=2, nets (16,16,16)", odd, odd_kw,
              B7_STEPS))
    transition = launch_sched.LR_TRANSITION_STEPS
    for label, tasks, kw, n_steps in cases:
        model = vi_model(tasks, **kw)
        if not model._fused_path_ok():
            raise AssertionError(f"fused_vi ({label}): the learner is off the fused path")
        launch_sched.LR_TRANSITION_STEPS = B2_STAIR_TRANSITION
        try:
            trainer = vi_trainer(model)
            got = vi_state(model)
            want = [t.clone() for t in got]
            got_loss, _ = trainer.run(*got, n_steps, 0)
            for s0, sub in trainer.launches(0, n_steps):
                counts = trainer.count_pages(s0, sub) if trainer.counted else None
                want_loss, _ = vk.fused_vi_train_ref(
                    *want, model.X, model.Y, model.mask, trainer.w_t, trainer.eps_pages(s0, sub),
                    s0, launch_sched.staircase_lr(1e-3, trainer.lr_decay, s0), 0.01, counts,
                    hidden=trainer.hidden, wps=0.5, bps=3.0, mll_const=trainer.mll_const,
                    n_steps=sub)
        finally:
            launch_sched.LR_TRANSITION_STEPS = transition
        torch.cuda.synchronize()
        skip = model.hyper_prior.slice_of(("kernel_nn", "b_out"))
        diffs = [diff_excluding(g.cpu(), w.cpu(), skip) for g, w in zip(got[:2], want[:2])]
        d_max, d_mean = max(d[0] for d in diffs), max(d[1] for d in diffs)
        rel = [diff_excluding(g.cpu(), w.cpu(), skip)[0] / float(w.abs().max())
               for g, w in zip(got[2:], want[2:])]
        loss_rel = abs(float(got_loss) - float(want_loss)) / abs(float(want_loss))
        print(f"  fused_vi, {label}, {n_steps} steps: |loc, log_scale diff| max {d_max:.3e}, "
              f"mean {d_mean:.3e}; Adam m, v max diff / max |plain| {max(rel):.3e}; last loss "
              f"rel diff {loss_rel:.3e} (kernel_nn.b_out excluded)")
        if not (d_max <= TWIN_ATOL and d_mean <= TWIN_MEAN_ATOL
                and max(rel) <= B2_MOMENT_RTOL and loss_rel <= B6_LOSS_RTOL):
            raise AssertionError(f"fused_vi ({label}): kernel disagrees with its plain version")
        errs["fused_vi"] = max(errs.get("fused_vi", 0.0), d_max)

    # per step at the main path's launch: 512 steps from prebuilt noise pages;
    # the plain version over 5 steps
    model = vi_model(train)
    trainer = vi_trainer(model)
    n_launch = trainer.MAX_LAUNCH
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pages = trainer.eps_pages(0, n_launch)
    host_s = time.perf_counter() - t0
    draw_ms = statistics.median(median_ms(lambda: trainer.eps_pages(0, n_launch), 3))
    print(f"  fused_vi, noise pages of {n_launch} steps: host {1e3 * host_s:.2f} ms to enqueue, "
          f"device {draw_ms:.2f} ms ({1e3 * draw_ms / n_launch:.2f} us a step)")
    data = (model.X, model.Y, model.mask, trainer.w_t)
    kw = dict(hidden=trainer.hidden, wps=0.5, bps=3.0, mll_const=trainer.mll_const)
    k_state, p_state = vi_state(model), vi_state(model)
    k_ms, p_ms = time_pair(
        lambda: vk.fused_vi_train(*k_state, *data, pages, 0, 1e-3, 0.01, n_steps=n_launch, **kw),
        lambda: vk.fused_vi_train_ref(*p_state, *data, pages[:5], 0, 1e-3, 0.01, n_steps=5, **kw),
        reps=3)
    times["fused_vi"] = (k_ms / n_launch, p_ms / 5)
    t, n, d = model.X.shape
    cluster_report("fused_vi", model.svi_batch_size, t, n, d, trainer.hidden)
    # the window's largest S and the odd shape: their plans and times a step
    for label, tasks, kw in (("S=32", train, {"svi_batch_size": 32}),
                             ("the odd shape", odd, odd_kw)):
        other = vi_model(tasks, **kw)
        other_trainer = vi_trainer(other)
        cluster_report("fused_vi", other.svi_batch_size, *other.X.shape,
                       other_trainer.hidden)
        other_pages = other_trainer.eps_pages(0, 200)
        other_state = vi_state(other)
        other_ms = statistics.median(median_ms(lambda: vk.fused_vi_train(
            *other_state, other.X, other.Y, other.mask, other_trainer.w_t, other_pages, 0, 1e-3,
            0.01, hidden=other_trainer.hidden, wps=0.5, bps=3.0,
            mll_const=other_trainer.mll_const, n_steps=200), 3)) / 200
        print(f"  fused_vi at {label}: {other_ms:.4f} ms a step (launches of 200 steps)")
    # per step: S samples' scores (both nets forward and backward, the task
    # MLLs, the sample, the hyper-prior term and its quad), the reduction over
    # the samples, and Adam on loc and log_scale
    s, p, (t, n, d) = model.svi_batch_size, model.hyper_prior.dim, model.X.shape
    step_flops = (s * (2 * mlp_flops(t * n, d, (32, 32), 1) + t * gp_task_flops(n, 1) + 10 * p)
                  + 3 * s * p + 24 * p)
    # a step reads its noise page; a launch reads and writes the state once and
    # reads the data once
    work["fused_vi"] = (step_flops,
                        4 * (s * p + (12 * p + t * n * (d + 2) + t) / n_launch))


def phase2_b4(errs, times, work, library, walls):
    """B4 against its plain version at its main paths' shapes, at N on both
    sides of the shared-memory edge, and on a batch of escalating systems."""
    import torch

    from meta_learning_pacoh_torch.ops.cuda import blocked_mll_kernel as bk
    from meta_learning_pacoh_torch.ops.cuda import chol_kernel

    gen = torch.Generator().manual_seed(4)
    timed = {}
    for label, b, n in B4_CASES + (B4_ESCALATION,):
        kn = spd(b, n, gen, scale=0.5)
        if label == B4_ESCALATION[0]:
            for i in (3, 9):
                kn[i] = escalating_systems(n, gen, -5e-5)
            for i in (5, 12):
                kn[i] = escalating_systems(n, gen, -5e-3)
            eye = torch.eye(n, device="cuda")
            ok = [chol_kernel.diag_ok(chol_kernel.cholesky_ref(kn + j * eye))
                  for j in (0.0, 1e-4, 1e-2)]
            level = torch.where(ok[0], 0, torch.where(ok[1], 1, 2))
            if set(level.tolist()) != {0, 1, 2}:
                raise AssertionError(f"escalation levels hit: {sorted(set(level.tolist()))}")
        r = torch.randn(b, n, generator=gen).cuda()
        where = "shared" if bk.blocked_in_shared(n) else "device"
        print(f"  blocked_fwd/bwd, {label} (the matrix in {where} memory):")
        for name, g_, w_ in zip(("quad", "logdet", "L", "z"), bk.blocked_mll_fwd(kn, r),
                                bk.blocked_mll_fwd_ref(kn, r)):
            check("blocked_fwd", g_.reshape(b, -1), w_.reshape(b, -1), errs)
            print(f"    ({name})")
        _, _, L, z = bk.blocked_mll_fwd_ref(kn, r)
        gq = torch.randn(b, generator=gen).cuda()
        gl = torch.randn(b, generator=gen).cuda()
        for name, g_, w_ in zip(("dkn", "dr"), bk.blocked_mll_bwd(L, z, gq, gl),
                                bk.blocked_mll_bwd_ref(L, z, gq, gl)):
            check("blocked_bwd", g_, w_, errs)
            print(f"    ({name})")
        check_bwd_on_kernel_fwd(bk, kn, r, gq, gl, errs)
        if n == 200 and label != B4_ESCALATION[0]:  # the main paths' shapes: timed
            timed[b] = (kn, r, L, z, gq, gl)
    edge_gen = torch.Generator().manual_seed(44)
    for b, n in B4_EDGES:
        kn = spd(b, n, edge_gen, scale=0.5)
        r = torch.randn(b, n, generator=edge_gen).cuda()
        where = "shared" if bk.blocked_in_shared(n) else "device"
        print(f"  blocked_fwd, B={b}, N={n} (the system in {where} memory):")
        for name, g_, w_ in zip(("quad", "logdet", "L", "z"), bk.blocked_mll_fwd(kn, r),
                                bk.blocked_mll_fwd_ref(kn, r)):
            check("blocked_fwd", g_.reshape(b, -1), w_.reshape(b, -1), errs)
            print(f"    ({name})")
        check_bwd_on_kernel_fwd(bk, kn, r, torch.randn(b, generator=edge_gen).cuda(),
                                torch.randn(b, generator=edge_gen).cuda(), errs)
    # a system that fails at every jitter level: NaN out of the forward, NaN
    # out of the backward; the others' dKn exactly symmetric
    for n in (200, 400):
        kn = spd(4, n, edge_gen, scale=0.5)
        kn[1] -= 10.0 * torch.eye(n, device="cuda")
        r = torch.randn(4, n, generator=edge_gen).cuda()
        _, _, L, z = bk.blocked_mll_fwd(kn, r)
        dkn, dr = bk.blocked_mll_bwd(L, z, torch.randn(4, generator=edge_gen).cuda(),
                                     torch.randn(4, generator=edge_gen).cuda())
        keep = torch.tensor([0, 2, 3], device="cuda")
        if not (bool(torch.isnan(dkn[1]).all()) and bool(torch.isnan(dr[1]).all())
                and not bool(torch.isnan(dkn[keep]).any())
                and torch.equal(dkn[keep], dkn[keep].mT)):
            raise AssertionError(f"blocked_bwd at N={n}: a failed system is not NaN, or dKn "
                                 f"is not symmetric")
        print(f"  blocked_bwd at N={n}: the failed system NaN, the others' dKn symmetric")
    print(f"  blocked_fwd: {bk.blocked_fwd_blocks_per_sm(200)} resident blocks per SM at N=200; "
          f"blocked_bwd: {bk.blocked_bwd_blocks_per_sm(200)} at N=200, "
          f"{bk.blocked_bwd_blocks_per_sm(300)} at N=300")
    for b in (5, 50):  # the general steps' batches: one wave of blocks
        kn, r, L, z, gq, gl = timed[b]
        fwd = device_pair(f"blocked_fwd at B={b}", lambda: bk.blocked_mll_fwd(kn, r),
                          lambda: bk.blocked_mll_fwd_ref(kn, r), walls)
        bwd = device_pair(f"blocked_bwd at B={b}", lambda: bk.blocked_mll_bwd(L, z, gq, gl),
                          lambda: bk.blocked_mll_bwd_ref(L, z, gq, gl), walls)
        lib_ms = device_ms(lambda: torch.linalg.cholesky_ex(kn))[0]
        inv_ms = device_ms(lambda: torch.cholesky_inverse(L))[0]
        print(f"  blocked_fwd/bwd at B={b}, N=200: kernel {fwd[0]:.5f} / {bwd[0]:.5f} ms, "
              f"plain {fwd[1]:.5f} / {bwd[1]:.5f} ms (device); torch.linalg.cholesky_ex "
              f"{lib_ms:.5f} ms, torch.cholesky_inverse {inv_ms:.5f} ms")
    kn, r, L, z, gq, gl = timed[200]
    b, n = kn.shape[0], kn.shape[-1]
    times["blocked_fwd"] = device_pair("blocked_fwd", lambda: bk.blocked_mll_fwd(kn, r),
                                       lambda: bk.blocked_mll_fwd_ref(kn, r), walls)
    times["blocked_bwd"] = device_pair("blocked_bwd", lambda: bk.blocked_mll_bwd(L, z, gq, gl),
                                       lambda: bk.blocked_mll_bwd_ref(L, z, gq, gl), walls)
    library["blocked_fwd"] = library_time("blocked_fwd", lambda: torch.linalg.cholesky_ex(kn))
    # the backward's yardstick: K^-1 alone from L, as the forward's is the factor alone
    library["blocked_bwd"] = library_time("blocked_bwd", lambda: torch.cholesky_inverse(L))
    # forward: one factorization (no system escalates here), the solve, quad
    # and logdet; in: the lower triangle of Kn (all it reads), r; out: L (the
    # square), z, quad, logdet. Backward: L^-1 (N^3/3) and the symmetric
    # W^T W (N^3/3), the outer product; in: the lower triangle of L, z, gq,
    # gl; out: dKn, dr
    tri = n * (n + 1) // 2
    work["blocked_fwd"] = (b * (n ** 3 / 3 + n * n + 3 * n), 4 * b * (tri + n + n * n + n + 2))
    work["blocked_bwd"] = (b * (2 * n ** 3 / 3 + 3 * n * n), 4 * b * (tri + n + 2 + n * n + n))


def check_bwd_on_kernel_fwd(bk, kn, r, gq, gl, errs):
    """B4's backward, fed the kernel forward's L and z, against its plain
    version on the same L and z (recorded apart from the backward's own row)."""
    import torch

    _, _, L, z = bk.blocked_mll_fwd(kn, r)
    keep = ~torch.isnan(z).any(dim=1)
    for g_, w_ in zip(bk.blocked_mll_bwd(L[keep], z[keep], gq[keep], gl[keep]),
                      bk.blocked_mll_bwd_ref(L[keep], z[keep], gq[keep], gl[keep])):
        check("blocked_bwd on the forward kernel's L, z", g_, w_, errs)


def bign_data():
    """bench.py's map_t5_n200 data (bench.py:155-156) and 20 test tasks of
    200 context and 200 test points drawn after it from the same environment."""
    import numpy as np

    from meta_learning_pacoh_torch.datasets import SinusoidDataset

    env = SinusoidDataset(random_state=np.random.RandomState(5))
    train = env.generate_meta_train_data(n_tasks=5, n_samples=200)
    test = env.generate_meta_test_data(n_tasks=20, n_samples_context=200, n_samples_test=200)
    return train, test


def bign_model(tasks, seed=1, **kw):
    """bench.py's map_t5_n200 learner (bench.py:157-158), on the card by default."""
    from meta_learning_pacoh_torch import GPRegressionMetaLearned

    kw = {"task_batch_size": -1, **kw}
    return GPRegressionMetaLearned(tasks, num_iter_fit=BIGN_STEPS, random_seed=seed, **kw)


def phase2_b9(errs, times, work):
    """B9 against its plain version at the map_t5_n200 shapes and one odd
    shape, from the learner's initial state."""
    import numpy as np
    import torch

    from meta_learning_pacoh_torch.models.random_gp import layout_slice
    from meta_learning_pacoh_torch.ops import launch_sched
    from meta_learning_pacoh_torch.ops.cuda import fused_map_bign_kernel as bg

    train, _ = bign_data()
    rs = np.random.RandomState(9)  # ragged tasks of up to 300 points, D=2, padded by the learner
    odd = [(rs.uniform(-2.0, 2.0, (m, 2)), rs.randn(m)) for m in (300, 250, 300, 120)]
    odd_kw = dict(feature_dim=3, mean_nn_layers=(16, 16, 16), kernel_nn_layers=(16, 16, 16))
    cases = (("full batch", train, {}, B6_STEPS),
             ("sampled batch of 2", train, {"task_batch_size": 2}, B6_STEPS),
             ("staircase lr_decay 0.5", train, {"lr_decay": 0.5}, B6_STAIR_STEPS),
             ("ragged tasks of up to 300 points, D=2, F=3, nets (16,16,16)", odd, odd_kw,
              B6_STEPS),
             ("3 tasks of 512 points", faceoff_tasks(3, 512), {}, B6_STEPS),
             ("5 tasks of 48 points, nets (7,7): the scalar passes", faceoff_tasks(5, 48),
              dict(mean_nn_layers=(7, 7), kernel_nn_layers=(7, 7)), B6_STEPS),
             ("5 tasks of 33 points, F=3, nets (12,20,4)/(8,16)", faceoff_tasks(5, 33),
              dict(feature_dim=3, mean_nn_layers=(12, 20, 4), kernel_nn_layers=(8, 16)),
              B6_STEPS),
             ("200 tasks of 12 points, sampled batch of 37 (two tasks a block)",
              faceoff_tasks(200, 12), dict(task_batch_size=37, mean_nn_layers=(8, 8),
                                           kernel_nn_layers=(8, 8)), B6_STEPS))
    transition = launch_sched.LR_TRANSITION_STEPS
    for label, tasks, kw, n_steps in cases:
        model = bign_model(tasks, **kw)
        if not model._fused_path_ok():
            raise AssertionError(f"fused_map_bign ({label}): the learner is off the fused path")
        launch_sched.LR_TRANSITION_STEPS = B2_STAIR_TRANSITION
        try:
            trainer = model._fused_trainer()
            got = [model.params.clone(), torch.zeros_like(model.params),
                   torch.zeros_like(model.params)]
            want = [t.clone() for t in got]
            got_loss, _ = trainer.run(*got, n_steps, 0)
            for s0, sub in trainer.launches(0, n_steps):
                counts = trainer.count_pages(s0, sub) if trainer.counted else None
                want_loss, _ = bg.fused_map_bign_train_ref(
                    *want, model.X, model.Y, model.mask, trainer.w_t, s0,
                    launch_sched.staircase_lr(1e-3, trainer.lr_decay, s0), model.weight_decay,
                    counts, layout=model.layout, n_steps=sub)
        finally:
            launch_sched.LR_TRANSITION_STEPS = transition
        torch.cuda.synchronize()
        skip = layout_slice(model.layout, ("kernel_nn", "b_out"))
        d_max, d_mean = diff_excluding(got[0].cpu(), want[0].cpu(), skip)
        rel = [diff_excluding(g.cpu(), w.cpu(), skip)[0] / float(w.abs().max())
               for g, w in zip(got[1:], want[1:])]
        loss_rel = abs(float(got_loss) - float(want_loss)) / abs(float(want_loss))
        t, n, d = model.X.shape
        plan = bg.bign_plan(t, n, d, model.cfg.feature_dim, model.cfg.mean_nn_layers,
                            model.cfg.kernel_nn_layers)
        print(f"  fused_map_bign, {label} ({plan[0]} blocks of {plan[1]} tasks, "
              f"{BIGN_PLACEMENT[plan[2]]}, {'tiled' if plan[3] else 'scalar'} nets), {n_steps} steps: "
              f"|param diff| max {d_max:.3e}, mean {d_mean:.3e}; AdamW m, v max diff / max "
              f"|plain| {rel[0]:.3e}, {rel[1]:.3e}; last loss rel diff {loss_rel:.3e} "
              f"(kernel_nn.b_out excluded)")
        if not (d_max <= TWIN_ATOL and d_mean <= TWIN_MEAN_ATOL
                and max(rel) <= B2_MOMENT_RTOL and loss_rel <= B6_LOSS_RTOL):
            raise AssertionError(f"fused_map_bign ({label}): kernel disagrees with its plain "
                                 f"version")
        errs["fused_map_bign"] = max(errs.get("fused_map_bign", 0.0), d_max)

    # per step: the kernel over a launch of 100 full-batch steps, the plain version over 3
    model = bign_model(train)
    trainer = model._fused_trainer()
    n_launch = 100
    k_state = [model.params.clone(), torch.zeros_like(model.params),
               torch.zeros_like(model.params)]
    p_state = [t.clone() for t in k_state]
    data = (model.X, model.Y, model.mask, trainer.w_t)
    k_ms, p_ms = time_pair(
        lambda: bg.fused_map_bign_train(*k_state, *data, 0, 1e-3, 0.0, layout=model.layout,
                                        n_steps=n_launch),
        lambda: bg.fused_map_bign_train_ref(*p_state, *data, 0, 1e-3, 0.0, layout=model.layout,
                                            n_steps=3),
        reps=3)
    times["fused_map_bign"] = (k_ms / n_launch, p_ms / 3)
    # a step: both nets over the T*N rows forward and backward; per task the
    # Gram matrix and its chains (about N^2 (3F + 20)), the factor, L^-1 and
    # the symmetric K^-1 (N^3/3 each); AdamW. A launch reads and writes
    # theta, m, v once and reads the data once
    p, (t, n, d) = model.params.numel(), model.X.shape
    f = model.cfg.feature_dim
    step_flops = (mlp_flops(t * n, d, (32, 32), 1) + mlp_flops(t * n, d, (32, 32), f)
                  + t * (n ** 3 + n * n * (3 * f + 20)) + 12 * p)
    work["fused_map_bign"] = (step_flops, 4 * (6 * p + t * n * (d + 2) + t) / n_launch)
    print(f"  fused_map_bign: ptxas {ptxas_usage('fused_map_bign_kernel')} (registers, spill "
          f"stores and loads in bytes)")
    map_bign_escalation()


MAP_ESC_OUTPUTSCALE_RAW = 1000.0


def map_bign_escalation():
    """B9 on map_t5_n200's tasks with each input and target duplicated in
    pairs, an outputscale of 1000 and a noise of softplus(-30) (the noise
    floor of 1e-3 is then 1e-6 of the Gram matrix's scale): float32 fails
    the factor at level 0 where
    float64 does not, so B9 is held to its plain version in float64 at the
    levels a float32 factor takes (``level_dtype``): no further from it than
    twice the float32 plain version (or the twins' limits; two float32 orders
    part chaotically on these systems), and nearer to it than to the float64
    run at level 0. Returns the distances it prints."""
    import torch

    from meta_learning_pacoh_torch.models.random_gp import layout_slice
    from meta_learning_pacoh_torch.ops.cuda import fused_map_bign_kernel as bg

    model = bign_model(bign_escalating_tasks())
    trainer = model._fused_trainer()
    start = model.params.clone()
    start[layout_slice(model.layout, ("outputscale_raw",))] = MAP_ESC_OUTPUTSCALE_RAW
    start[layout_slice(model.layout, ("noise_raw",))] = BIGN_ESC_NOISE_RAW
    data = (model.X, model.Y, model.mask)
    kw = dict(layout=model.layout, n_steps=B6_STEPS)
    state = lambda: [start.clone(), torch.zeros_like(start), torch.zeros_like(start)]  # noqa: E731
    got, want = state(), state()
    bg.fused_map_bign_train(*got, *data, trainer.w_t, 0, 1e-3, model.weight_decay, **kw)
    bg.fused_map_bign_train_ref(*want, *data, trainer.w_t, 0, 1e-3, model.weight_decay, **kw)
    wide = {}
    for level in (None, torch.float32):
        wide[level] = [t.double() for t in state()]
        bg.fused_map_bign_train_ref(*wide[level], *(t.double() for t in data), trainer.w_t, 0,
                                    1e-3, model.weight_decay, level_dtype=level, **kw)
    skip = layout_slice(model.layout, ("kernel_nn", "b_out"))
    k32 = diff_excluding(got[0].cpu().double(), wide[torch.float32][0].cpu(), skip)
    p32 = diff_excluding(want[0].cpu().double(), wide[torch.float32][0].cpu(), skip)
    k64 = diff_excluding(got[0].cpu().double(), wide[None][0].cpu(), skip)
    print(f"  fused_map_bign, escalation: duplicated inputs, outputscale softplus("
          f"{MAP_ESC_OUTPUTSCALE_RAW}), noise softplus({BIGN_ESC_NOISE_RAW}), {B6_STEPS} steps: |param diff| to the float64 plain run at "
          f"the float32 levels max {k32[0]:.3e}, mean {k32[1]:.3e} (plain float32 {p32[0]:.3e}, "
          f"{p32[1]:.3e}); to the float64 run at level 0 {k64[0]:.3e}, {k64[1]:.3e}")
    if not (k32[0] <= 2 * max(p32[0], TWIN_ATOL) and k32[1] <= 2 * max(p32[1], TWIN_MEAN_ATOL)
            and k32[1] < k64[1]):
        raise AssertionError("fused_map_bign (escalation): the kernel is off its float64 plain "
                             "version at the escalated levels")
    return {"b9": k32, "b9_plain32": p32, "b9_level0": k64}


def phase2_b5(errs, times, work, library, walls):
    """B5 against its plain version at N in {32, 50, 64} and B in {1, 20, 200,
    257}, on a batch with an indefinite matrix, and on one with pivots
    below float32's smallest normal (the NaN pattern of the plain version
    on the card); both instances' registers and local memory; timed at the
    MLAP eval's B=20, N=50 (and at B=1 and at B=200, the SVGD and VI
    evals')."""
    import torch

    from meta_learning_pacoh_torch.ops.cuda import chol_kernel, chol_small_kernel

    report_usage("chol_small (N <= 32)", "chol_small_warp_kernelILi1", "pacoh_chol_small_usage", 0)
    report_usage("chol_small (33 <= N <= 64)", "chol_small_warp_kernelILi2",
                 "pacoh_chol_small_usage", 1)
    gen = torch.Generator().manual_seed(5)
    for n in B5_NS:
        for b in B5_BS:
            a = spd(b, n, gen)
            check("chol_small", chol_small_kernel.cholesky_small(a), chol_kernel.cholesky_ref(a),
                  errs)
            print(f"    (B={b}, N={n})")
    a = spd(20, 50, gen)
    lam = torch.linalg.eigvalsh(a[7])
    a[7] -= (lam[0] + 0.05 * (lam[1] - lam[0]) + 1e-3) * torch.eye(50, device="cuda")
    got, want = chol_small_kernel.cholesky_small(a), chol_kernel.cholesky_ref(a)
    nan_got, nan_want = torch.isnan(got), torch.isnan(want)
    others = torch.arange(20) != 7
    if not (torch.equal(nan_got, nan_want) and bool(nan_want[7].all())
            and not bool(nan_want[others].any())):
        raise AssertionError("chol_small: NaN pattern differs from the plain version")
    check("chol_small", got[others.cuda()], want[others.cuda()], errs)
    print("    (B=20, N=50, matrix 7 indefinite: all NaN, its neighbours factored)")
    a = spd(4, 50, gen)
    for k in (0, 17):  # pivots 0 and 17 at 1e-39, their rows and columns zero elsewhere
        a[2, k, :] = 0.0
        a[2, :, k] = 0.0
        a[2, k, k] = 1e-39
    got, want = chol_small_kernel.cholesky_small(a), chol_kernel.cholesky_ref(a)
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError("chol_small: NaN pattern differs from the plain version's on a "
                             "denormal pivot")
    factored = ~torch.isnan(want).reshape(4, -1).any(1)
    print(f"  chol_small: pivots of 1e-39 in matrix 2, factored by the plain version on the card: "
          f"{bool(factored[2])}; the kernel's NaN pattern is the plain version's")
    check("chol_small", got[factored], want[factored], errs)
    for b in (1, 20, 200):
        a = spd(b, 50, gen)
        # a bound as a default: the B=20 calls are profiled after the loop
        k_ms, p_ms = device_pair(f"chol_small at B={b}",
                                 lambda a=a: chol_small_kernel.cholesky_small(a),
                                 lambda a=a: chol_kernel.cholesky_ref(a), walls)
        lib_fn = lambda a=a: torch.linalg.cholesky_ex(a)  # noqa: E731
        lib_ms = library_time("chol_small", lib_fn) if b == 20 else device_ms(lib_fn)[0]
        print(f"  chol_small at B={b}, N=50: kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms, "
              f"torch.linalg.cholesky_ex {lib_ms:.5f} ms (device)")
        if b == 20:  # the MLAP eval's predictive covariances
            times["chol_small"], library["chol_small"] = (k_ms, p_ms), lib_ms
            note_unqueued("chol_small plain", UNQUEUED.get(f"chol_small at B={b} plain"),
                          f"chol_small at B={b} plain" in UNQUEUED)
            walls["chol_small"] = walls[f"chol_small at B={b}"]
            # in: the lower triangle of each matrix (all the kernel reads); out: the square
            work["chol_small"] = (b * 50 ** 3 / 3, 4 * b * (50 * 51 // 2 + 50 * 50))


def conditioned_tasks(rs, t, n, d=1, sizes=None):
    """t tasks of n points (the first sizes[i] of task i), evenly spread along
    a line through the input space, each shifted a little: with the state of
    ``conditioned_state`` the inner KL's gram is well conditioned."""
    import numpy as np

    direction = np.linspace(1.0, 0.5, d)
    tasks = []
    for i in range(t):
        m = n if sizes is None else sizes[i]
        x = (np.linspace(-3.0, 3.0, n)[:m, None] * direction[None, :]
             + rs.uniform(-0.2, 0.2, (1, d)))
        tasks.append((x, np.sin(x.sum(axis=1)) + 0.1 * rs.randn(m)))
    return tasks


def conditioned_params(hyper_prior, mask, raw_noise, rs):
    """An MLAP state (the JAX learner's nested numpy form) whose kernel net
    maps the inputs of ``conditioned_tasks`` monotonically to features about
    two lengthscales apart: small positive weights (their layer sums about
    1, so no unit saturates), lengthscale 0.25, the posterior's scales at
    0.1 as a learner's initial ones; mask [T, N] the tasks' padding. There
    the plain version's float32 and float64 runs of 30 steps stay within
    1e-5 of each other (CPU)."""
    import numpy as np

    hp, hidden = hyper_prior, tuple(hyper_prior.cfg.kernel_nn_layers)
    t, n = mask.shape
    h = hidden[0]
    loc = 0.1 * rs.randn(hp.dim)
    widths = (hp.cfg.input_dim,) + hidden
    for i in range(len(hidden)):
        scale = 1.0 if i == 0 else 4.0 / h
        loc[hp.slice_of(("kernel_nn", f"w_{i}"))] = scale * rs.uniform(
            0.2, 0.4, widths[i] * widths[i + 1])
        loc[hp.slice_of(("kernel_nn", f"b_{i}"))] = rs.uniform(-0.1, 0.1, h)
    loc[hp.slice_of(("kernel_nn", "w_out"))] = rs.uniform(2.0, 4.0, h) / h
    loc[hp.slice_of(("kernel_nn", "b_out"))] = 0.0
    loc[hp.slice_of(("lengthscale_raw",))] = -1.25  # lengthscale 0.25
    f32 = np.float32
    return {"hyper_post": {"loc": loc.astype(f32),
                           "log_scale": (np.log(0.1) + 0.1 * rs.randn(hp.dim)).astype(f32)},
            "raw_noise": np.asarray(raw_noise, f32),
            "q_means": (0.1 * rs.randn(t, n) * mask).astype(f32),
            "q_trils": (np.tril(0.1 * rs.randn(t, n, n)) + np.eye(n)).astype(f32)}


def conditioned_state(model, rs):
    """``conditioned_params`` for an MLAP learner, as its ``state_dict()``
    with zero Adam moments."""
    import numpy as np

    params = conditioned_params(model.hyper_prior, model.mask.cpu().numpy(),
                                model.params["raw_noise"].cpu().numpy(), rs)
    zeros = {k: ({kk: np.zeros_like(vv) for kk, vv in v.items()} if isinstance(v, dict)
                 else np.zeros_like(v)) for k, v in params.items()}
    return {"params": params, "opt_state": {"mu": zeros, "nu": zeros, "count": 0}, "step": 0}


def mlap_model(tasks, seed=1, **kw):
    """bench.py's mlap learner (bench.py:147-149), on the card by default."""
    from meta_learning_pacoh_torch import GPRegressionMetaLearnedPAC

    return GPRegressionMetaLearnedPAC(tasks, num_iter_fit=MLAP_STEPS, random_seed=seed,
                                      covar_module="NN", mean_module="NN", meta_kl_weight=1e-3,
                                      **kw)


def mlap_state(model):
    """Copies of an MLAP learner's state and its Adam moments (STATE_KEYS)."""
    return [{k: tree[k].clone() for k in ("loc", "log_scale", "q_means", "q_trils",
                                           "raw_noise")}
            for tree in (model.params, model._mu, model._nu)]


def compare_mlap(label, got, want, got_loss, want_loss, skip, meta_test=False):
    """Assert the twins' tolerances on an MLAP state and its moments; returns
    the max parameter difference."""
    import torch

    keys = ("q_means", "q_trils") if meta_test else ("loc", "log_scale", "q_means",
                                                    "q_trils", "raw_noise")
    d_max = d_mean = rel = 0.0
    for k in keys:
        a, b = got[0][k].cpu().reshape(-1), want[0][k].cpu().reshape(-1)
        keep = torch.ones(a.numel(), dtype=torch.bool)
        if k in ("loc", "log_scale"):
            keep[skip] = False
        d = (a - b).abs()[keep]
        d_max, d_mean = max(d_max, float(d.max())), max(d_mean, float(d.mean()))
        for tree_g, tree_w in zip(got[1:], want[1:]):
            mg, mw = tree_g[k].cpu().reshape(-1)[keep], tree_w[k].cpu().reshape(-1)[keep]
            rel = max(rel, float((mg - mw).abs().max()) / max(float(mw.abs().max()), 1e-30))
    loss_rel = abs(float(got_loss) - float(want_loss)) / abs(float(want_loss))
    print(f"  fused_mlap, {label}: |state diff| max {d_max:.3e}, mean {d_mean:.3e}; Adam m, v "
          f"max diff / max |plain| {rel:.3e}; last loss rel diff {loss_rel:.3e} "
          f"(kernel_nn.b_out excluded)")
    if not (d_max <= TWIN_ATOL and d_mean <= TWIN_MEAN_ATOL and rel <= B2_MOMENT_RTOL
            and loss_rel <= B6_LOSS_RTOL):
        raise AssertionError(f"fused_mlap ({label}): kernel disagrees with its plain version")
    return d_max


def phase2_b8(errs, times, work):
    """B8 against its plain version at the mlap shapes (sin_20's S=5, T=20,
    N=5, D=1, nets (32,32)) and one odd shape, from a well-conditioned state,
    at every cluster size its plan can return: 30 steps full batch, with a
    sampled batch's count pages, across a staircase, and 30 meta-test steps
    at 20 and at 5 tasks; then one step's gradient at the sin_20 learner's
    own initial state; then the times of a 512-step launch and the plans."""
    import numpy as np
    import torch

    from meta_learning_pacoh_torch.ops import launch_sched
    from meta_learning_pacoh_torch.ops.cuda import fused_mlap_kernel as mk
    from meta_learning_pacoh_torch.ops.cuda import fused_svgd_kernel as fk

    rs = np.random.RandomState(8)
    cases = (
        ("full batch", dict(), None, 1.0, False, (20, 5, 1), None),
        ("sampled batch of 5", dict(task_batch_size=5), 5, 1.0, False, (20, 5, 1), None),
        ("staircase lr_decay 0.5", dict(lr_decay=0.5), 20, 0.5, False, (20, 5, 1), None),
        ("meta-test, 20 tasks", dict(), None, 1.0, True, (20, 5, 1), None),
        ("S=3, 7 ragged tasks of up to 7 points, D=2, nets (16,16,16)",
         dict(svi_batch_size=3, mean_nn_layers=(16, 16, 16), kernel_nn_layers=(16, 16, 16)),
         7, 1.0, False, (7, 7, 2), (7, 5, 7, 3, 7, 6, 2)),
        # last, so that the cases above keep the data they drew before it
        ("meta-test, 5 tasks", dict(), None, 1.0, True, (5, 5, 1), None),
    )
    transition = launch_sched.LR_TRANSITION_STEPS
    for label, kw, batch, decay, meta_test, (t, n, d), sizes in cases:
        model = mlap_model(conditioned_tasks(rs, t, n, d, sizes), **kw)
        model.load_state_dict(conditioned_state(model, rs))
        if not model._fused_path_ok():
            raise AssertionError(f"fused_mlap ({label}): the learner is off the fused path")
        hidden = tuple(model.cfg.mean_nn_layers)
        lr_main, lr_post = (1e-2, 1e-2) if meta_test else (1e-3, 1e-3)
        eps = torch.randn(B8_STEPS, model.svi_batch_size, model.hyper_prior.dim,
                          generator=torch.Generator().manual_seed(len(label))).cuda()
        counts = None
        if batch is not None:
            counts = torch.stack([torch.bincount(model._task_draw(i), minlength=t).float()
                                  for i in range(B8_STEPS)]).cuda()
        kw8 = dict(hidden=hidden, wps=0.5, bps=3.0, task_kl_weight=1.0, meta_kl_weight=1e-3,
                   delta=0.1, n_tasks=t, meta_test=meta_test)
        launch_sched.LR_TRANSITION_STEPS = B2_STAIR_TRANSITION
        plans = [c for c in fk.CLUSTER_SIZES
                 if c <= t and model.svi_batch_size <= fk.RESIDENT_CLUSTERS[c]]
        runs = {c: mlap_state(model) for c in plans}
        losses = {}
        want = mlap_state(model)
        try:
            for s0, sub in launch_sched.staircase_launches(0, B8_STEPS, 512, decay):
                c_page = None if counts is None else counts[s0:s0 + sub]
                lrs = (launch_sched.staircase_lr(lr_main, decay, s0),
                       launch_sched.staircase_lr(lr_post, decay, s0))
                for c, got in runs.items():
                    losses[c], _, _ = mk.fused_mlap_train(*got, model.X, model.Y, model.mask,
                                                          eps[s0:s0 + sub], c_page, s0, *lrs,
                                                          batch=batch, n_steps=sub, cluster=c,
                                                          **kw8)
                want_loss, _, _ = mk.fused_mlap_train_ref(*want, model.X, model.Y, model.mask,
                                                          eps[s0:s0 + sub], c_page, s0, *lrs,
                                                          n_steps=sub, **kw8)
        finally:
            launch_sched.LR_TRANSITION_STEPS = transition
        torch.cuda.synchronize()
        skip = model.hyper_prior.slice_of(("kernel_nn", "b_out"))
        plan = mk.cluster_plan(model.svi_batch_size, t, n, d, hidden)
        for c, got in runs.items():
            name = f"C={c}{' (the plan)' if c == plan[0] else ''}"
            d_max = compare_mlap(f"{label}, {name}, {B8_STEPS} steps", got, want, losses[c],
                                 want_loss, skip, meta_test)
            errs["fused_mlap"] = max(errs.get("fused_mlap", 0.0), d_max)

    # one step's gradient at the sin_20 learner's own initial state (lr 0: the
    # first moments are 0.1 g), against the plain version in float32 and float64
    train, _ = sin20()
    model = mlap_model(train)
    hidden = tuple(model.cfg.mean_nn_layers)
    eps = torch.empty(1, model.svi_batch_size, model.hyper_prior.dim, device="cuda")
    model._draw_eps(0, eps[0])
    counts = torch.bincount(model._task_draw(0), minlength=20).float()[None].cuda()
    kw8 = dict(hidden=hidden, wps=0.5, bps=3.0, task_kl_weight=1.0, meta_kl_weight=1e-3,
               delta=0.1, n_tasks=20, n_steps=1)
    grads = {}
    for label, dtype in (("kernel", torch.float32), ("plain", torch.float32),
                         ("plain64", torch.float64)):
        state = [{k: v.to(dtype) for k, v in tree.items()} for tree in mlap_state(model)]
        data = [a.to(dtype) for a in (model.X, model.Y, model.mask, eps, counts)]
        if label == "kernel":
            mk.fused_mlap_train(*state, *data, 0, 0.0, 0.0, batch=20, **kw8)
        else:
            mk.fused_mlap_train_ref(*state, *data, 0, 0.0, 0.0, **kw8)
        grads[label] = {k: 10.0 * v.double().cpu() for k, v in state[1].items()}
    skip = model.hyper_prior.slice_of(("kernel_nn", "b_out"))
    for k in grads["plain"]:
        g_k, g_p, g_64 = (grads[lbl][k].reshape(-1) for lbl in ("kernel", "plain", "plain64"))
        if k in ("loc", "log_scale"):
            keep = torch.ones(g_k.numel(), dtype=torch.bool)
            keep[skip] = False
            g_k, g_p, g_64 = g_k[keep], g_p[keep], g_64[keep]
        scale = float(g_64.abs().max())
        gap_k, gap_32 = (float((g_k - g_p).abs().max()) / scale,
                         float((g_p - g_64).abs().max()) / scale)
        print(f"  fused_mlap, sin_20 initial state, one gradient, {k}: kernel - plain "
              f"{gap_k:.3e}, plain float32 - float64 {gap_32:.3e} (of the largest entry)")
        if not gap_k <= max(B8_GRAD_FACTOR * gap_32, 1e-4):
            raise AssertionError(f"fused_mlap: the sin_20 gradient of {k} disagrees")

    # per step at the main path's launch: 512 steps from the sin_20 learner's
    # initial state and its own pages; the plain version over 3 steps
    trainer = mk.FusedMLAPTrainer(
        model.X, model.Y, model.mask, hidden=hidden, lr=1e-3, posterior_lr_multiplier=1.0,
        svi_batch_size=model.svi_batch_size, task_batch_size=20, task_kl_weight=1.0,
        meta_kl_weight=1e-3, delta=0.1, weight_prior_std=0.5, bias_prior_std=3.0,
        eps_draw=model._draw_eps, task_draw=model._task_draw)
    n_launch = trainer.MAX_LAUNCH
    eps, counts = trainer.eps_pages(0, n_launch), trainer.count_pages(0, n_launch)
    data = (model.X, model.Y, model.mask)
    kw8 = dict(hidden=hidden, wps=0.5, bps=3.0, task_kl_weight=1.0, meta_kl_weight=1e-3,
               delta=0.1, n_tasks=20)
    k_state, p_state = mlap_state(model), mlap_state(model)
    k_ms, p_ms = time_pair(
        lambda: mk.fused_mlap_train(*k_state, *data, eps, counts, 0, 1e-3, 1e-3, batch=20,
                                    n_steps=n_launch, **kw8),
        lambda: mk.fused_mlap_train_ref(*p_state, *data, eps[:3], counts[:3], 0, 1e-3, 1e-3,
                                        n_steps=3, **kw8),
        reps=3)
    times["fused_mlap"] = (k_ms / n_launch, p_ms / 3)
    mt_state = mlap_state(model)
    mt_ms = statistics.median(median_ms(
        lambda: mk.fused_mlap_train(mt_state[0], *mt_state[1:], *data, eps, None, 0, 0.0, 1e-2,
                                    meta_test=True, n_steps=n_launch, **kw8), 3)) / n_launch
    # bench.py's meta-test row: 5 context sets of the sin_20 test tasks
    ctx = mlap_model([task[:2] for task in sin20()[1][:5]])
    ctx_state = mlap_state(ctx)
    ctx_ms = statistics.median(median_ms(
        lambda: mk.fused_mlap_train(ctx_state[0], *ctx_state[1:], ctx.X, ctx.Y, ctx.mask, eps,
                                    None, 0, 0.0, 1e-2, meta_test=True, n_steps=n_launch,
                                    **kw8), 3)) / n_launch
    print(f"  fused_mlap, meta-test mode: kernel {mt_ms:.4f} ms a step at 20 tasks, "
          f"{ctx_ms:.4f} at 5")
    cluster_report("fused_mlap", model.svi_batch_size, *model.X.shape, hidden)
    cluster_report("fused_mlap", ctx.svi_batch_size, *ctx.X.shape, hidden)
    # a step: S samples' both nets forward and backward over T*N rows, the
    # S*T KL systems (the factorization trials, L^-1, K^-1, K^-1 L0 and the
    # gram's chain, about 4 N^3 + 12 N^2), the reduction over the samples and
    # the two Adam updates; it reads its noise and count pages, and a launch
    # reads and writes the state and its moments once and reads the data once
    s, p, (t, n, d) = model.svi_batch_size, model.hyper_prior.dim, model.X.shape
    q_size = t * n * (n + 1)
    step_flops = (s * (2 * mlp_flops(t * n, d, hidden, 1) + t * (4 * n ** 3 + 12 * n * n)
                       + 8 * p) + 3 * s * p + 24 * p + 20 * q_size)
    work["fused_mlap"] = (step_flops,
                          4 * (s * p + t + (6 * (2 * p + q_size + 1) + t * n * (d + 2))
                               / n_launch))


def many_sin(n_tasks):
    """n_tasks sinusoid tasks of 5 points (sin_20's environment, another seed)."""
    import numpy as np

    from meta_learning_pacoh_torch.datasets import SinusoidDataset

    env = SinusoidDataset(random_state=np.random.RandomState(n_tasks))
    return env.generate_meta_train_data(n_tasks=n_tasks, n_samples=5)


def step_bound_ms(step_flops, step_bytes):
    """The least time of a step on the card, PERF.md's rule: the larger of its
    operations over the float32 peak and its bytes over the memory rate."""
    t_ops, t_bytes = step_flops / PEAK_FLOPS, step_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def phase2_many_tasks(errs):
    """B2, B7 and B8 at task counts beyond the window of the one-block
    kernel: B2 and B7 at T in MANY_B2_TASKS (sin_20's learners, 5 points a
    task), B8's fit and meta-test mode at MANY_B8_FIT_TASKS and
    MANY_B8_TEST_TASKS (mlap's learner, a well-conditioned state), each
    against its plain version with phase 2's limits, from the learner's
    initial state; the plan (tiled where tile < ceil(T / C)), the time a
    step of a launch of MANY_TIMED_STEPS steps and its bound."""
    import numpy as np
    import torch

    from meta_learning_pacoh_torch.ops.cuda import fused_mlap_kernel as mk
    from meta_learning_pacoh_torch.ops.cuda import fused_svgd_kernel as fk
    from meta_learning_pacoh_torch.ops.cuda import fused_vi_kernel as vk

    hidden, n_timed = (32, 32), MANY_TIMED_STEPS
    for t in MANY_B2_TASKS:
        train = many_sin(t)
        # B2: the full batch, B2_STEPS steps
        model = sin20_model(train)
        if not model._fused_path_ok():
            raise AssertionError(f"fused_svgd at T={t}: the learner is off the fused path")
        trainer = fk.FusedSVGDTrainer(
            model.X, model.Y, model.mask, hidden=hidden, lr=1e-3, prior_factor=0.01,
            weight_prior_std=0.5, bias_prior_std=3.0, task_batch_size=model.task_batch_size,
            task_draw=model._task_draw)
        got = [model.particles.clone(), torch.zeros_like(model.particles),
               torch.zeros_like(model.particles)]
        want = [a.clone() for a in got]
        trainer.run(*got, B2_STEPS, 0)
        fk.fused_svgd_train_ref(*want, model.X, model.Y, model.mask, trainer.w_t, 0, 1e-3, 0.01,
                                hidden=hidden, wps=0.5, bps=3.0, n_steps=B2_STEPS)
        torch.cuda.synchronize()
        skip = model.hyper_prior.slice_of(("kernel_nn", "b_out"))
        d_max, d_mean = diff_excluding(got[0].cpu(), want[0].cpu(), skip)
        rel = [diff_excluding(g.cpu(), w.cpu(), skip)[0] / float(w.abs().max())
               for g, w in zip(got[1:], want[1:])]
        k, p, (_, n, d) = 10, model.hyper_prior.dim, model.X.shape
        plan = cluster_report("fused_svgd", k, t, n, d, hidden)
        timed = [model.particles.clone(), torch.zeros_like(model.particles),
                 torch.zeros_like(model.particles)]
        ms = statistics.median(median_ms(lambda: fk.fused_svgd_train(
            *timed, model.X, model.Y, model.mask, trainer.w_t, 0, 1e-3, 0.01, hidden=hidden,
            wps=0.5, bps=3.0, n_steps=n_timed), 3)) / n_timed
        bound, by = step_bound_ms(
            k * (2 * mlp_flops(t * n, d, hidden, 1) + t * gp_task_flops(n, 1)) + 7 * k * k * p
            + 12 * k * p, 4 * (6 * k * p + t * n * (d + 2) + t) / n_timed)
        print(f"  fused_svgd at T={t}, N={n} (plan {plan}, tiled {plan[3] < -(-t // plan[0])}), "
              f"{B2_STEPS} steps: |particle diff| max {d_max:.3e}, mean {d_mean:.3e}; Adam m, v "
              f"max diff / max |plain| {rel[0]:.3e}, {rel[1]:.3e}; {ms:.5f} ms a step "
              f"(launches of {n_timed}), bound {bound:.6f} ms ({by})")
        if not (d_max <= TWIN_ATOL and d_mean <= TWIN_MEAN_ATOL and max(rel) <= B2_MOMENT_RTOL):
            raise AssertionError(f"fused_svgd at T={t}: kernel disagrees with its plain version")
        errs["fused_svgd"] = max(errs.get("fused_svgd", 0.0), d_max)

        # B7: the full batch, B7_STEPS steps with the learner's own noise
        model = vi_model(train)
        if not model._fused_path_ok():
            raise AssertionError(f"fused_vi at T={t}: the learner is off the fused path")
        trainer = vi_trainer(model)
        got = vi_state(model)
        want = [a.clone() for a in got]
        got_loss, _ = trainer.run(*got, B7_STEPS, 0)
        want_loss, _ = vk.fused_vi_train_ref(
            *want, model.X, model.Y, model.mask, trainer.w_t, trainer.eps_pages(0, B7_STEPS), 0,
            1e-3, 0.01, hidden=trainer.hidden, wps=0.5, bps=3.0, mll_const=trainer.mll_const,
            n_steps=B7_STEPS)
        torch.cuda.synchronize()
        diffs = [diff_excluding(g.cpu(), w.cpu(), skip) for g, w in zip(got[:2], want[:2])]
        d_max, d_mean = max(x[0] for x in diffs), max(x[1] for x in diffs)
        rel = [diff_excluding(g.cpu(), w.cpu(), skip)[0] / float(w.abs().max())
               for g, w in zip(got[2:], want[2:])]
        loss_rel = abs(float(got_loss) - float(want_loss)) / abs(float(want_loss))
        s_ = model.svi_batch_size
        plan = cluster_report("fused_vi", s_, t, n, d, hidden)
        pages, timed = trainer.eps_pages(0, n_timed), vi_state(model)
        ms = statistics.median(median_ms(lambda: vk.fused_vi_train(
            *timed, model.X, model.Y, model.mask, trainer.w_t, pages, 0, 1e-3, 0.01,
            hidden=hidden, wps=0.5, bps=3.0, mll_const=trainer.mll_const, n_steps=n_timed),
            3)) / n_timed
        bound, by = step_bound_ms(
            s_ * (2 * mlp_flops(t * n, d, hidden, 1) + t * gp_task_flops(n, 1) + 10 * p)
            + 3 * s_ * p + 24 * p, 4 * (s_ * p + (12 * p + t * n * (d + 2) + t) / n_timed))
        print(f"  fused_vi at T={t}, N={n} (plan {plan}, tiled {plan[2] < -(-t // plan[0])}), "
              f"{B7_STEPS} steps: |loc, log_scale diff| max {d_max:.3e}, mean {d_mean:.3e}; "
              f"Adam m, v max diff / max |plain| {max(rel):.3e}; last loss rel diff "
              f"{loss_rel:.3e}; {ms:.5f} ms a step (launches of {n_timed}), bound "
              f"{bound:.6f} ms ({by})")
        if not (d_max <= TWIN_ATOL and d_mean <= TWIN_MEAN_ATOL
                and max(rel) <= B2_MOMENT_RTOL and loss_rel <= B6_LOSS_RTOL):
            raise AssertionError(f"fused_vi at T={t}: kernel disagrees with its plain version")
        errs["fused_vi"] = max(errs.get("fused_vi", 0.0), d_max)

    # B8 from a well-conditioned state: its fit (the full batch) and its
    # meta-test mode, B8_STEPS steps
    rs = np.random.RandomState(21)
    cases = ([(t, False) for t in MANY_B8_FIT_TASKS]
             + [(t, True) for t in MANY_B8_TEST_TASKS])
    for t, meta_test in cases:
        model = mlap_model(conditioned_tasks(rs, t, 5))
        model.load_state_dict(conditioned_state(model, rs))
        if not model._fused_path_ok():
            raise AssertionError(f"fused_mlap at T={t}: the learner is off the fused path")
        s_, p, (_, n, d) = model.svi_batch_size, model.hyper_prior.dim, model.X.shape
        lrs = (0.0, 1e-2) if meta_test else (1e-3, 1e-3)
        eps = torch.randn(B8_STEPS, s_, p, generator=torch.Generator().manual_seed(t)).cuda()
        kw8 = dict(hidden=hidden, wps=0.5, bps=3.0, task_kl_weight=1.0, meta_kl_weight=1e-3,
                   delta=0.1, n_tasks=t, meta_test=meta_test)
        got, want = mlap_state(model), mlap_state(model)
        got_loss, _, _ = mk.fused_mlap_train(*got, model.X, model.Y, model.mask, eps, None, 0,
                                             *lrs, n_steps=B8_STEPS, **kw8)
        want_loss, _, _ = mk.fused_mlap_train_ref(*want, model.X, model.Y, model.mask, eps, None,
                                                  0, *lrs, n_steps=B8_STEPS, **kw8)
        torch.cuda.synchronize()
        plan = cluster_report("fused_mlap", s_, t, n, d, hidden)
        label = (f"{'meta-test mode' if meta_test else 'fit'} at T={t}, N={n} (plan {plan}, "
                 f"tiled {plan[2] < -(-t // plan[0])}), {B8_STEPS} steps")
        d_max = compare_mlap(label, got, want, got_loss, want_loss,
                             model.hyper_prior.slice_of(("kernel_nn", "b_out")), meta_test)
        errs["fused_mlap"] = max(errs.get("fused_mlap", 0.0), d_max)
        pages = torch.randn(n_timed, s_, p, generator=torch.Generator().manual_seed(t)).cuda()
        timed = mlap_state(model)
        ms = statistics.median(median_ms(lambda: mk.fused_mlap_train(
            *timed, model.X, model.Y, model.mask, pages, None, 0, *lrs, n_steps=n_timed, **kw8),
            3)) / n_timed
        # as phase2_b8's step; in meta-test mode both nets forward only and no
        # reduction over the samples or Adam of the hyper-posterior
        q_size, sizes = t * n * (n + 1), (d, *hidden, 1)
        nets = (4 * t * n * sum(a * b for a, b in zip(sizes[:-1], sizes[1:])) if meta_test
                else 2 * mlp_flops(t * n, d, hidden, 1))
        bound, by = step_bound_ms(
            s_ * (nets + t * (4 * n ** 3 + 12 * n * n) + 8 * p)
            + (0 if meta_test else 3 * s_ * p + 24 * p) + 20 * q_size,
            4 * (s_ * p + (6 * (2 * p + q_size + 1) + t * n * (d + 2)) / n_timed))
        print(f"  fused_mlap {'meta-test mode' if meta_test else 'fit'} at T={t}: {ms:.5f} ms "
              f"a step (launches of {n_timed}), bound {bound:.6f} ms ({by})")


def bign_svgd_model(tasks, seed=1, **kw):
    """bench.py's svgd_t5_n200 learner (bench.py:166-168), on the card by default."""
    from meta_learning_pacoh_torch import GPRegressionMetaLearnedSVGD

    kw = {"task_batch_size": -1, "num_particles": 10, "prior_factor": 0.01, **kw}
    return GPRegressionMetaLearnedSVGD(tasks, num_iter_fit=BIGN_STEPS, random_seed=seed, **kw)


def bign_vi_model(tasks, seed=1, **kw):
    """bench.py's vi_t5_n200 learner (bench.py:174-175: the VI learner's defaults,
    svi_batch_size 10, prior_factor 0.01, diag), on the card by default."""
    from meta_learning_pacoh_torch import GPRegressionMetaLearnedVI

    kw = {"task_batch_size": -1, **kw}
    return GPRegressionMetaLearnedVI(tasks, num_iter_fit=BIGN_STEPS, random_seed=seed, **kw)


def bign_odd_tasks(seed):
    """Two odd shapes of the big-N SVGD and VI kernels: 3 ragged tasks of up to
    240 points, D=2 (the learner pads them to N=240: the matrix in device
    memory), and 26 ragged tasks of up to 20 points, D=1 (G > 128 systems at
    K=6: two systems a block)."""
    import numpy as np

    rs = np.random.RandomState(seed)
    wide = [(rs.uniform(-2.0, 2.0, (m, 2)), rs.randn(m)) for m in (240, 180, 240)]
    many = [(rs.uniform(-2.0, 2.0, (m, 1)), rs.randn(m)) for m in [20] * 25 + [12]]
    return wide, many


def cauchy20():
    """The ``cauchy_20`` meta-train tasks (20 x 20 points, D=2) and its 200
    test tasks (``provide_data("cauchy_20", seed=28)``)."""
    from meta_learning_pacoh_torch.datasets import provide_data

    train, _, test = provide_data("cauchy_20", seed=28)
    return train, test


def bign_step_flops(t, n, d, hidden, n_sys):
    """About the flops of n_sys big-N systems of a step: both nets over the
    task's rows forward and backward, the Gram matrix and its chains (about
    N^2 23), the factor, L^-1 and the symmetric K^-1 (N^3/3 each)."""
    return n_sys * (2 * mlp_flops(n, d, hidden, 1) + n ** 3 + 23 * n * n)


def data_of(model):
    return model.X, model.Y, model.mask


def gaps(a, b, n_params, skip):
    """Two states' (parameters' max |diff|, their mean |diff|, the Adam
    moments' max |diff| over max |b|), the first n_params tensors of each
    parameters and the rest moments, the columns in ``skip`` left out."""
    pairs = [(x.cpu().double(), y.cpu().double()) for x, y in zip(a, b)]
    d = [diff_excluding(x, y, skip) for x, y in pairs[:n_params]]
    rel = max(diff_excluding(x, y, skip)[0] / float(y.abs().max()) for x, y in pairs[n_params:])
    return max(g[0] for g in d), max(g[1] for g in d), rel


def check_bign(name, label, got, want, wide, n_params, skip):
    """B10 or B11 (``got``) against its plain version in float64 (``wide``),
    the state's first n_params tensors parameters, the rest Adam moments:
    parameters within the twins' tolerances, moments within B2_MOMENT_RTOL of
    their largest value. Prints the plain version in float32 (``want``)
    beside it, and its own distance to the float64 run: at the hyper-prior's
    particles (saturated tanh units, an ill-conditioned Gram matrix) the
    float32 plain version flips the sign of gradients below about 1e-5 of the
    largest, and Adam's first steps turn a flip into a step of 2 lr. Returns
    the parameters' max difference to the float64 run."""
    k64, p64, kp = (gaps(a, b, n_params, skip) for a, b in
                    ((got, wide), (want, wide), (got, want)))
    print(f"    kernel - plain float64: |param diff| max {k64[0]:.3e}, mean {k64[1]:.3e}, Adam "
          f"m, v max diff / max |plain| {k64[2]:.3e}; plain float32 - float64: {p64[0]:.3e}, "
          f"{p64[1]:.3e}, {p64[2]:.3e}; kernel - plain float32: {kp[0]:.3e}, {kp[1]:.3e}, "
          f"{kp[2]:.3e} (kernel_nn.b_out excluded)")
    if not (k64[0] <= TWIN_ATOL and k64[1] <= TWIN_MEAN_ATOL and k64[2] <= B2_MOMENT_RTOL):
        raise AssertionError(f"{name} ({label}): kernel disagrees with its plain version")
    return k64[0]


# The big-N kernels' escalation case: svgd_t5_n200 / vi_t5_n200's learners on
# their tasks with the inputs and targets duplicated in pairs and every
# particle's (sample's) noise at softplus(-30) (about 1e-13): the Gram matrix
# plus 1e-6 fails to factor in float32 at level 0 and takes the jitter 1e-4,
# while in float64 it factors at level 0. So the kernels are held to their
# plain versions in float64 at the level a float32 factor picks
# (``level_dtype``). Float32 cannot meet the twins' limits on such a matrix
# (on an H100 the float32 plain version's particles lie 3.4e-2 max, 3.3e-3
# mean from that run after 20 steps, its first-step loss 2.7e-3 off), so B10
# must lie no further from it than the float32 plain version does, B11's
# first-step loss within BIGN_ESC_LOSS_RTOL of it (a few times the float32
# plain version's gap), and both far from the level-0 run.
BIGN_ESC_NOISE_RAW = -30.0
BIGN_ESC_LOSS_RTOL = 1e-2


def bign_escalating_tasks():
    """The svgd_t5_n200 tasks with each input and target duplicated in pairs."""
    train, _ = bign_data()
    return [(x[0::2].repeat(2, axis=0), y[0::2].repeat(2, axis=0)) for x, y in train]


def bign_escalation():
    """The escalation case (above) through B10 (20 steps, one launch) and B11
    (one step): returns the distances it prints, raises where the kernels
    did not escalate or lie off their limits."""
    import torch

    from meta_learning_pacoh_torch.ops.cuda import fused_svgd_bign_kernel as sb
    from meta_learning_pacoh_torch.ops.cuda import fused_vi_bign_kernel as vb

    tasks = bign_escalating_tasks()
    model = bign_svgd_model(tasks)
    noise = model.hyper_prior.slice_of(("noise_raw",))
    data = data_of(model)
    wide_data = [t.double() for t in data]
    trainer = sb.FusedSVGDBigNTrainer(*data, hidden=(32, 32), lr=1e-3, prior_factor=0.01,
                                      weight_prior_std=0.5, bias_prior_std=3.0)
    start = model.particles.clone()
    start[:, noise] = BIGN_ESC_NOISE_RAW
    kw = dict(hidden=(32, 32), wps=0.5, bps=3.0, n_steps=B6_STEPS)
    state = lambda: [start.clone(), torch.zeros_like(start), torch.zeros_like(start)]  # noqa: E731
    got, want = state(), state()
    sb.fused_svgd_bign_train(*got, *data, trainer.w_t, 0, 1e-3, 0.01, **kw)
    sb.fused_svgd_bign_train_ref(*want, *data, trainer.w_t, 0, 1e-3, 0.01, **kw)
    wide = {}
    for level in (None, torch.float32):
        wide[level] = [t.double() for t in state()]
        sb.fused_svgd_bign_train_ref(*wide[level], *wide_data, trainer.w_t, 0, 1e-3, 0.01,
                                     level_dtype=level, **kw)
    skip = model.hyper_prior.slice_of(("kernel_nn", "b_out"))
    k32 = diff_excluding(got[0].cpu().double(), wide[torch.float32][0].cpu(), skip)
    p32 = diff_excluding(want[0].cpu().double(), wide[torch.float32][0].cpu(), skip)
    k64 = diff_excluding(got[0].cpu().double(), wide[None][0].cpu(), skip)
    print(f"  fused_svgd_bign, escalation: duplicated inputs, noise softplus({BIGN_ESC_NOISE_RAW}), "
          f"{B6_STEPS} steps: |param diff| to the float64 plain run at the float32 level max "
          f"{k32[0]:.3e}, mean {k32[1]:.3e} (plain float32 {p32[0]:.3e}, {p32[1]:.3e}); to the "
          f"float64 run at level 0 {k64[0]:.3e}, {k64[1]:.3e}")
    if not (k32[0] <= p32[0] and k32[1] <= p32[1] and k32[1] < k64[1]):
        raise AssertionError("fused_svgd_bign (escalation): the kernel is off its float64 plain "
                             "version at the escalated level")

    vi = bign_vi_model(tasks)
    post = vi_state(vi)
    post[0][noise] = BIGN_ESC_NOISE_RAW
    post[1][noise] = math.log(1e-3)
    vtrainer = bign_vi_trainer(vi)
    eps = vtrainer.eps_pages(0, 1)
    kw = dict(hidden=(32, 32), wps=0.5, bps=3.0, mll_const=vtrainer.mll_const, n_steps=1)
    loss_k, _ = vb.fused_vi_bign_train(*[t.clone() for t in post], *data_of(vi), vtrainer.w_t, eps,
                                       0, 1e-3, 0.01, **kw)
    loss_p, _ = vb.fused_vi_bign_train_ref(*[t.clone() for t in post], *data_of(vi), vtrainer.w_t,
                                           eps, 0, 1e-3, 0.01, **kw)
    loss = {}
    for level in (None, torch.float32):
        loss[level], _ = vb.fused_vi_bign_train_ref(
            *[t.double() for t in post], *(t.double() for t in data_of(vi)), vtrainer.w_t,
            eps.double(), 0, 1e-3, 0.01, level_dtype=level, **kw)
    ref, flat = float(loss[torch.float32]), float(loss[None])
    rel, rel_p, rel_0 = (abs(float(v) - ref) / abs(ref) for v in (loss_k, loss_p, flat))
    print(f"  fused_vi_bign, escalation: first-step loss {float(loss_k):.7e}, rel diff to the "
          f"float64 plain run at the float32 level ({ref:.7e}) {rel:.3e} (plain float32 "
          f"{rel_p:.3e}); the float64 run at level 0 {flat:.7e}")
    if not (rel <= BIGN_ESC_LOSS_RTOL and abs(float(loss_k) - flat) > 0.5 * abs(flat)):
        raise AssertionError("fused_vi_bign (escalation): the kernel's loss is not the escalated "
                             "system's")
    return {"b10": k32, "b10_plain32": p32, "b11_loss_rel": rel}


def phase2_b10(errs, times, work):
    """B10 against its plain version at the svgd_t5_n200 shapes, at
    cauchy_20's and at two odd shapes, from the learner's initial state."""
    import torch

    from meta_learning_pacoh_torch.ops import launch_sched
    from meta_learning_pacoh_torch.ops.cuda import fused_svgd_bign_kernel as sb

    train, _ = bign_data()
    cauchy, _ = cauchy20()
    wide, many = bign_odd_tasks(10)
    cases = (("full batch", train, {}, B6_STEPS),
             ("sampled batch of 2", train, {"task_batch_size": 2}, B6_STEPS),
             ("staircase lr_decay 0.5", train, {"lr_decay": 0.5}, B6_STAIR_STEPS),
             ("cauchy_20: 20 tasks x 20 points, D=2, phase 3's learner", cauchy, {"seed": 30},
              B6_STEPS),
             ("3 ragged tasks of up to 240 points, D=2, K=6, nets (16,16,16)", wide,
              dict(num_particles=6, mean_nn_layers=(16, 16, 16), kernel_nn_layers=(16, 16, 16)),
              B6_STEPS),
             ("the same tasks, K=4, nets (128,128): the matrix in device memory", wide,
              dict(num_particles=4, mean_nn_layers=(128, 128), kernel_nn_layers=(128, 128)),
              B6_STEPS),
             ("26 ragged tasks of up to 20 points, K=6", many, dict(num_particles=6), B6_STEPS))
    transition = launch_sched.LR_TRANSITION_STEPS
    for label, tasks, kw, n_steps in cases:
        model = bign_svgd_model(tasks, **kw)
        if not model._fused_path_ok():
            raise AssertionError(f"fused_svgd_bign ({label}): the learner is off the fused path")
        hidden = tuple(model.cfg.mean_nn_layers)
        launch_sched.LR_TRANSITION_STEPS = B2_STAIR_TRANSITION
        try:
            trainer = sb.FusedSVGDBigNTrainer(
                model.X, model.Y, model.mask, hidden=hidden, lr=1e-3, prior_factor=0.01,
                weight_prior_std=0.5, bias_prior_std=3.0, lr_decay=kw.get("lr_decay", 1.0),
                task_batch_size=model.task_batch_size, task_draw=model._task_draw)
            got = [model.particles.clone(), torch.zeros_like(model.particles),
                   torch.zeros_like(model.particles)]
            want = [t.clone() for t in got]
            wide = [t.double() for t in got]
            trainer.run(*got, n_steps, 0)
            for s0, sub in trainer.launches(0, n_steps):
                counts = trainer.count_pages(s0, sub) if trainer.counted else None
                args = (s0, launch_sched.staircase_lr(1e-3, trainer.lr_decay, s0), 0.01, counts)
                kw = dict(hidden=hidden, wps=0.5, bps=3.0, n_steps=sub)
                sb.fused_svgd_bign_train_ref(*want, model.X, model.Y, model.mask, trainer.w_t,
                                             *args, **kw)
                sb.fused_svgd_bign_train_ref(*wide, *(t.double() for t in data_of(model)),
                                             trainer.w_t, *args, **kw)
        finally:
            launch_sched.LR_TRANSITION_STEPS = transition
        torch.cuda.synchronize()
        skip = model.hyper_prior.slice_of(("kernel_nn", "b_out"))
        t, n, d = model.X.shape
        blocks, spb, shared, threads = sb.svgd_bign_plan(model.num_particles, t, n, d, hidden)
        print(f"  fused_svgd_bign, {label} ({blocks} blocks of {spb} systems, {threads} threads, "
              f"{BIGN_PLACEMENT[shared]}), {n_steps} steps:")
        if "device memory" in label and shared != 0:
            raise AssertionError(f"fused_svgd_bign ({label}): planned placement {shared}")
        d_max = check_bign("fused_svgd_bign", label, got, want, wide, 1, skip)
        errs["fused_svgd_bign"] = max(errs.get("fused_svgd_bign", 0.0), d_max)

    # per step: the kernel over a launch of 100 full-batch steps, the plain version
    # over 3, at the svgd_t5_n200 shapes (the kernels line) and at cauchy_20's
    n_launch, step_ms = 100, {}
    for label, model in (("svgd_t5_n200", bign_svgd_model(train)),
                         ("cauchy_20", bign_svgd_model(cauchy, seed=30))):
        k_state = [model.particles.clone(), torch.zeros_like(model.particles),
                   torch.zeros_like(model.particles)]
        p_state = [t.clone() for t in k_state]
        trainer = sb.FusedSVGDBigNTrainer(model.X, model.Y, model.mask, hidden=(32, 32),
                                          lr=1e-3, prior_factor=0.01, weight_prior_std=0.5,
                                          bias_prior_std=3.0)
        data = (model.X, model.Y, model.mask, trainer.w_t)
        kw = dict(hidden=(32, 32), wps=0.5, bps=3.0)
        k_ms, p_ms = time_pair(
            lambda: sb.fused_svgd_bign_train(*k_state, *data, 0, 1e-3, 0.01, n_steps=n_launch,
                                             **kw),
            lambda: sb.fused_svgd_bign_train_ref(*p_state, *data, 0, 1e-3, 0.01, n_steps=3,
                                                 **kw),
            reps=3)
        step_ms[label] = (k_ms / n_launch, p_ms / 3)
        print(f"  fused_svgd_bign at the {label} shapes: {k_ms / n_launch:.4f} ms a step "
              f"(launches of {n_launch}), plain version {p_ms / 3:.4f} ms a step")
    model = bign_svgd_model(train)
    times["fused_svgd_bign"] = step_ms["svgd_t5_n200"]
    # a step: the K T systems, the transport and Adam (as B2's); a launch reads
    # and writes theta, m, v once and reads the data once
    k, p, (t, n, d) = 10, model.hyper_prior.dim, model.X.shape
    step_flops = bign_step_flops(t, n, d, (32, 32), k * t) + 7 * k * k * p + 12 * k * p
    work["fused_svgd_bign"] = (step_flops, 4 * (6 * k * p + t * n * (d + 2) + t) / n_launch)


def bign_vi_trainer(model):
    from meta_learning_pacoh_torch.ops.cuda.fused_vi_bign_kernel import FusedVIBigNTrainer

    return FusedVIBigNTrainer(model.X, model.Y, model.mask,
                              hidden=tuple(model.cfg.mean_nn_layers), lr=model._lr,
                              prior_factor=model.prior_factor,
                              weight_prior_std=model._weight_prior_std,
                              bias_prior_std=model._bias_prior_std,
                              svi_batch_size=model.svi_batch_size, eps_draw=model._draw_eps,
                              lr_decay=model._lr_decay, task_batch_size=model.task_batch_size,
                              task_draw=model._task_draw)


def phase2_b11(errs, times, work):
    """B11 against its plain version at the vi_t5_n200 shapes, at cauchy_20's
    and at two odd shapes, from the learner's initial state, with the
    learner's own noise."""
    import torch

    from meta_learning_pacoh_torch.ops import launch_sched
    from meta_learning_pacoh_torch.ops.cuda import fused_vi_bign_kernel as vb

    train, _ = bign_data()
    cauchy, _ = cauchy20()
    wide, many = bign_odd_tasks(11)
    cases = (("full batch", train, {}, B6_STEPS),
             ("sampled batch of 2", train, {"task_batch_size": 2}, B6_STEPS),
             ("staircase lr_decay 0.5", train, {"lr_decay": 0.5}, B6_STAIR_STEPS),
             ("cauchy_20: 20 tasks x 20 points, D=2", cauchy, {"seed": 30}, B6_STEPS),
             ("S=3, 3 ragged tasks of up to 240 points, D=2, nets (16,16,16)", wide,
              dict(svi_batch_size=3, mean_nn_layers=(16, 16, 16),
                   kernel_nn_layers=(16, 16, 16)), B6_STEPS),
             ("S=4, the same tasks, nets (128,128): the matrix in device memory", wide,
              dict(svi_batch_size=4, mean_nn_layers=(128, 128), kernel_nn_layers=(128, 128)),
              B6_STEPS),
             ("S=6, 26 ragged tasks of up to 20 points", many, dict(svi_batch_size=6),
              B6_STEPS))
    transition = launch_sched.LR_TRANSITION_STEPS
    for label, tasks, kw, n_steps in cases:
        model = bign_vi_model(tasks, **kw)
        if not model._fused_path_ok():
            raise AssertionError(f"fused_vi_bign ({label}): the learner is off the fused path")
        launch_sched.LR_TRANSITION_STEPS = B2_STAIR_TRANSITION
        try:
            trainer = bign_vi_trainer(model)
            got = vi_state(model)
            want = [t.clone() for t in got]
            wide = [t.double() for t in got]
            got_loss, _ = trainer.run(*got, n_steps, 0)
            for s0, sub in trainer.launches(0, n_steps):
                counts = trainer.count_pages(s0, sub) if trainer.counted else None
                eps = trainer.eps_pages(s0, sub)
                args = (s0, launch_sched.staircase_lr(1e-3, trainer.lr_decay, s0), 0.01, counts)
                kw = dict(hidden=trainer.hidden, wps=0.5, bps=3.0, mll_const=trainer.mll_const,
                          n_steps=sub)
                vb.fused_vi_bign_train_ref(*want, model.X, model.Y, model.mask, trainer.w_t,
                                           eps, *args, **kw)
                wide_loss, _ = vb.fused_vi_bign_train_ref(
                    *wide, *(t.double() for t in data_of(model)), trainer.w_t, eps.double(),
                    *args, **kw)
        finally:
            launch_sched.LR_TRANSITION_STEPS = transition
        torch.cuda.synchronize()
        skip = model.hyper_prior.slice_of(("kernel_nn", "b_out"))
        t, n, d = model.X.shape
        blocks, spb, shared = vb.vi_bign_plan(model.svi_batch_size, t, n, d, trainer.hidden)
        loss_rel = abs(float(got_loss) - float(wide_loss)) / abs(float(wide_loss))
        print(f"  fused_vi_bign, {label} ({blocks} blocks of {spb} systems, "
              f"{BIGN_PLACEMENT[shared]}), {n_steps} steps: last loss rel diff to the float64 "
              f"plain run {loss_rel:.3e}")
        if "device memory" in label and shared != 0:
            raise AssertionError(f"fused_vi_bign ({label}): planned placement {shared}")
        d_max = check_bign("fused_vi_bign", label, got, want, wide, 2, skip)
        if not loss_rel <= B6_LOSS_RTOL:
            raise AssertionError(f"fused_vi_bign ({label}): kernel disagrees with its plain "
                                 f"version in the loss")
        errs["fused_vi_bign"] = max(errs.get("fused_vi_bign", 0.0), d_max)

    # per step: the kernel over a launch of 100 steps from prebuilt noise pages,
    # the plain version over 3, at the vi_t5_n200 shapes (the kernels line) and
    # at cauchy_20's
    n_launch, step_ms = 100, {}
    for label, model in (("vi_t5_n200", bign_vi_model(train)),
                         ("cauchy_20", bign_vi_model(cauchy, seed=30))):
        trainer = bign_vi_trainer(model)
        pages = trainer.eps_pages(0, n_launch)
        data = (model.X, model.Y, model.mask, trainer.w_t)
        kw = dict(hidden=trainer.hidden, wps=0.5, bps=3.0, mll_const=trainer.mll_const)
        k_state, p_state = vi_state(model), vi_state(model)
        k_ms, p_ms = time_pair(
            lambda: vb.fused_vi_bign_train(*k_state, *data, pages, 0, 1e-3, 0.01,
                                           n_steps=n_launch, **kw),
            lambda: vb.fused_vi_bign_train_ref(*p_state, *data, pages[:3], 0, 1e-3, 0.01,
                                               n_steps=3, **kw),
            reps=3)
        step_ms[label] = (k_ms / n_launch, p_ms / 3)
        print(f"  fused_vi_bign at the {label} shapes: {k_ms / n_launch:.4f} ms a step "
              f"(launches of {n_launch}), plain version {p_ms / 3:.4f} ms a step")
    model = bign_vi_model(train)
    times["fused_vi_bign"] = step_ms["vi_t5_n200"]
    # a step: the S T systems, each sample and its prior term, the reduction
    # over the samples and Adam on loc and log_scale; a step reads its noise
    # page, a launch reads and writes the state once and reads the data once
    s, p, (t, n, d) = model.svi_batch_size, model.hyper_prior.dim, model.X.shape
    step_flops = bign_step_flops(t, n, d, (32, 32), s * t) + 13 * s * p + 24 * p
    work["fused_vi_bign"] = (step_flops,
                             4 * (s * p + (12 * p + t * n * (d + 2) + t) / n_launch))


def diff_excluding(a, b, skip):
    """(max, mean) |a - b| over all but the columns in ``skip``."""
    import torch

    keep = torch.ones(a.shape[-1], dtype=torch.bool)
    keep[skip] = False
    d = (a - b).abs()[..., keep]
    return float(d.max()), float(d.mean())


def profile(label, fn, out_dir):
    """Trace fn once with torch.profiler; write the table, return a summary."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    fn()  # warm
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # device-side rows only: an operator's row repeats its kernels' time
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=40))
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "top": [(e.key[:60], e.self_device_time_total / 1e3, e.count) for e in top]}


def cauchy_model(train, **kw):
    """Phase 3's cauchy_20 learner: K=10, seed 30, the learner's defaults."""
    from meta_learning_pacoh_torch import GPRegressionMetaLearnedSVGD

    return GPRegressionMetaLearnedSVGD(train, num_particles=10, random_seed=30, device="cuda",
                                       **kw)


def cauchy_later_twins(train, later, skip):
    """TWIN_STEPS steps of cauchy_20 from a later state (200 steps after the
    twins' start) through B10, through the general step and through B10's
    plain version in float64 and in float32. B10's particles are held to the
    float64 run within the twins' tolerances (the measure of phase 3's twin
    check); the moments' gaps, the general step's and the float32 plain
    version's are printed. Returns the gaps (``gaps``) B10 - float64,
    general - float64, plain float32 - float64, B10 - general."""

    def state_of(m):
        return [m.particles, m._mu, m._nu]

    twins = {}
    for label, disabled in (("B10", "0"), ("general", "1")):
        os.environ["PACOH_TORCH_DISABLE_FUSED"] = disabled
        try:
            twin = cauchy_model(train)
            twin.load_state_dict(later)
            if twin._fused_path_ok() != (label == "B10"):
                raise AssertionError(f"PACOH_TORCH_DISABLE_FUSED={disabled}: wrong path")
            twin.meta_fit(n_iter=TWIN_STEPS, log_period=TWIN_STEPS, verbose=False)
            twins[label] = twin
        finally:
            os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
    wide = svgd_plain64(twins["B10"], later, TWIN_STEPS)
    narrow = svgd_plain64(twins["B10"], later, TWIN_STEPS, dtype="float32")
    k64, g64, kg = (gaps(state_of(a), b, 1, skip) for a, b in (
        (twins["B10"], wide), (twins["general"], wide),
        (twins["B10"], state_of(twins["general"]))))
    p64 = gaps(narrow, wide, 1, skip)
    print(f"  twins from the state 200 steps later ({TWIN_STEPS} steps; |particle diff| max, "
          f"mean; Adam m, v max diff / max; kernel_nn.b_out excluded): B10 - plain float64 "
          f"{k64[0]:.3e}, {k64[1]:.3e}, {k64[2]:.3e}; general - plain float64 {g64[0]:.3e}, "
          f"{g64[1]:.3e}, {g64[2]:.3e}; plain float32 - float64 {p64[0]:.3e}, {p64[1]:.3e}, "
          f"{p64[2]:.3e}; B10 - general {kg[0]:.3e}, {kg[1]:.3e}, {kg[2]:.3e}")
    if not (k64[0] <= TWIN_ATOL and k64[1] <= TWIN_MEAN_ATOL):
        raise AssertionError("cauchy_20: B10's particles disagree with its plain version in "
                             "float64 from the later state")
    lim = later_limits()
    print(f"  later-state limits from the JAX float32 step's own drift (tools/c1_drift.json, "
          f"twice it): particles max {lim[0]:.3e}, mean {lim[1]:.3e}, moments {lim[2]:.3e}")
    # the general step's own moments are printed, not held: a float32 path's
    # moments part from float64 by their JAX order there (1e-2)
    if not (g64[0] <= lim[0] and g64[1] <= lim[1] and k64[2] <= lim[2]):
        raise AssertionError("cauchy_20: from the later state the general step's particles or "
                             "B10's moments drift from float64 further than twice the JAX "
                             "float32 step does")
    return {"b10_f64": k64, "general_f64": g64, "plain32_f64": p64, "b10_general": kg}


def later_limits():
    """(particles max, mean, moments max / largest) limits of a float32 path's
    distance from its float64 run 20 steps from cauchy_20's later state: twice
    the JAX float32 general step's own distance from its float64 run there
    (tools/c1_drift.py, JAX on the CPU): the drift there is float32's, not
    the port's."""
    with open(C1_DRIFT_FILE) as f:
        gap = json.load(f)["gaps"]["later"]["jax_f32_vs_jax_f64"]
    return 2 * gap["max"], 2 * gap["mean"], 2 * gap["moments_rel"]


def phase3(profile_dir):
    """cauchy_20 through the public entry points, twice: as the learner
    dispatches it (NN/NN: B10 alone in the fit), with twins of that fit and
    eval (the kernels off; the general step), and with the SE covariance of
    the experiments' ``--covar_module SE`` (experiments/meta_base_exp.py:28),
    whose fit takes the general step (K1-K3) by default. Returns the launch
    counts of K1-K4 in the SE path's fit and eval, and a summary."""
    import numpy as np
    import torch

    from meta_learning_pacoh_torch.ops import cuda
    from meta_learning_pacoh_torch.ops.cuda.fused_svgd_bign_kernel import FusedSVGDBigNTrainer

    train, test = cauchy20()
    model = cauchy_model(train)
    print(f"  cauchy_20: {len(train)} tasks x {len(train[0][0])} points, "
          f"{len(test)} test tasks x {len(test[0][2])} test points, "
          f"K={model.num_particles}, P={model.hyper_prior.dim}")
    if not model._fused_path_ok():
        raise AssertionError("the cauchy_20 learner is off its default path (B10)")
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    fit_s = timed_fit(model, FIT_STEPS, FIT_STEPS)
    fit_launches = dict(cuda.LAUNCHES)
    print(f"  meta_fit: {FIT_STEPS} steps in {fit_s:.3f} s ({FIT_STEPS / fit_s:.1f} steps/s, "
          f"first call); launches in the fit: {fit_launches}")
    # every launch two blocks an SM (200 systems of N=20)
    if (fit_launches["fused_svgd_bign"] < 1 or type(model._fused) is not FusedSVGDBigNTrainer
            or fit_launches["fused_svgd_bign_coresident"] != fit_launches["fused_svgd_bign"]
            or any(v for k, v in fit_launches.items()
                   if k not in ("fused_svgd_bign", "fused_svgd_bign_coresident"))):
        raise AssertionError(f"the cauchy_20 fit was not carried by B10 alone, two blocks an "
                             f"SM: {fit_launches}")
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    ll, rmse, calib = model.eval_datasets(test)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    print(f"  eval_datasets: {len(test)} tasks in {eval_s:.3f} s (first call); LL {ll:.6f}, "
          f"RMSE {rmse:.6f}, calib {calib:.6f}; launches {dict(cuda.LAUNCHES)}")
    if not all(math.isfinite(v) for v in (ll, rmse, calib)):
        raise AssertionError("non-finite metrics")
    if model.particles.shape != (10, model.hyper_prior.dim) or not bool(
            torch.isfinite(model.particles).all()):
        raise AssertionError("particles are not finite of shape [K, P]")
    steady = FIT_STEPS / timed_fit(model, FIT_STEPS, FIT_STEPS)
    t0 = time.perf_counter()
    model.eval_datasets(test)
    torch.cuda.synchronize()
    eval_warm_s = time.perf_counter() - t0
    print(f"  steady state: {steady:.1f} steps/s; eval_datasets again: {eval_warm_s:.3f} s")
    # twins from one state, taken before any traced steps so that --profile
    # does not move it: the default path (B10), the kernels off (the plain
    # general step) and the fused kernel off (the general step: K1-K3)
    state = model.state_dict()
    traces = {}
    if profile_dir:
        traces["fit_100_steps"] = profile(
            "fit", lambda: model.meta_fit(n_iter=100, log_period=100, verbose=False),
            profile_dir)
        traces["eval"] = profile("eval", lambda: model.eval_datasets(test), profile_dir)
    else:  # the same steps untraced (profile() runs its fit twice): one later state
        for _ in range(2):
            model.meta_fit(n_iter=100, log_period=100, verbose=False)
    later = model.state_dict()

    skip = model.hyper_prior.slice_of(("kernel_nn", "b_out"))
    twins = {}
    for label, switch in (("B10", None), ("plain", "PACOH_TORCH_DISABLE_KERNELS"),
                          ("general", "PACOH_TORCH_DISABLE_FUSED")):
        if switch:
            os.environ[switch] = "1"
        try:
            twin = cauchy_model(train)
            twin.load_state_dict(state)
            cuda.reset_launch_counts()
            twin.meta_fit(n_iter=TWIN_STEPS, log_period=TWIN_STEPS, verbose=False)
            launches = dict(cuda.LAUNCHES)
            twins[label] = (twin.particles.detach().cpu().clone(),
                            twin.eval_datasets(test[:EVAL_TWIN_TASKS]), launches)
            if label == "general":
                general_steady = 100 / timed_fit(twin, 100, 100)
        finally:
            if switch:
                os.environ.pop(switch)
    general_launches = twins["general"][2]
    print(f"  general-step twin (PACOH_TORCH_DISABLE_FUSED=1): {TWIN_STEPS} steps, launches "
          f"{general_launches}; steady state {general_steady:.1f} steps/s (B10's "
          f"{steady:.1f}, {steady / general_steady:.2f}x)")
    if not (all(general_launches[k] > 0 for k in ("svgd_phi", "mll_fwd", "mll_bwd"))
            and general_launches["fused_svgd_bign"] == 0):
        raise AssertionError(f"the general-step twin did not run through K1-K3: "
                             f"{general_launches}")
    for other in ("plain", "general"):
        d_max, d_mean = diff_excluding(twins["B10"][0], twins[other][0], skip)
        m_k, m_o = np.asarray(twins["B10"][1]), np.asarray(twins[other][1])
        print(f"  twin fit ({TWIN_STEPS} steps), B10 - {other}: |particle diff| max "
              f"{d_max:.3e}, mean {d_mean:.3e} (kernel_nn.b_out excluded; tolerances "
              f"{TWIN_ATOL}, {TWIN_MEAN_ATOL}); eval ({EVAL_TWIN_TASKS} tasks) B10 "
              f"{m_k.tolist()}, {other} {m_o.tolist()}")
        if not (d_max <= TWIN_ATOL and d_mean <= TWIN_MEAN_ATOL):
            raise AssertionError(f"the B10 and {other} twins disagree")
        if not np.allclose(m_k, m_o, rtol=EVAL_TWIN_TOL, atol=EVAL_TWIN_TOL):
            raise AssertionError(f"the B10 and {other} twins' evals disagree")
    later_gaps = cauchy_later_twins(train, later, skip)

    # the SE covariance: the general step by default
    se = cauchy_model(train, covar_module="SE")
    if se._fused_path_ok():
        raise AssertionError("the SE-covariance learner took a fused path")
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    se_fit_s = timed_fit(se, FIT_STEPS, FIT_STEPS)
    t0 = time.perf_counter()
    se_ll, se_rmse, se_calib = se.eval_datasets(test)
    torch.cuda.synchronize()
    se_eval_s = time.perf_counter() - t0
    se_launches = {name: cuda.LAUNCHES[name] for name in GENERAL_STEP_KERNELS}
    print(f"  SE covariance: meta_fit {FIT_STEPS} steps in {se_fit_s:.3f} s "
          f"({FIT_STEPS / se_fit_s:.1f} steps/s, first call), eval_datasets {se_eval_s:.3f} s; "
          f"LL {se_ll:.6f}, RMSE {se_rmse:.6f}, calib {se_calib:.6f}; launches in the fit and "
          f"eval: {dict(cuda.LAUNCHES)}")
    if not all(v > 0 for v in se_launches.values()) or any(
            v for k, v in cuda.LAUNCHES.items() if k.startswith("fused")):
        raise AssertionError(f"the SE path did not run through K1-K4, or took a fused kernel: "
                             f"{dict(cuda.LAUNCHES)}")
    if not all(math.isfinite(v) for v in (se_ll, se_rmse, se_calib)) or not bool(
            torch.isfinite(se.particles).all()):
        raise AssertionError("the SE path: non-finite particles or metrics")
    se_steady = 100 / timed_fit(se, 100, 100)
    print(f"  SE covariance steady state: {se_steady:.1f} steps/s")
    if profile_dir:
        traces["se_fit_20_steps"] = profile(
            "se_fit", lambda: se.meta_fit(n_iter=20, log_period=20, verbose=False), profile_dir)
        traces["se_eval"] = profile("se_eval", lambda: se.eval_datasets(test), profile_dir)
    for label, summary in traces.items():
        print(f"  trace {label}: " + json.dumps(summary))
    return se_launches, dict(
        fit_s=fit_s, eval_s=eval_s, eval_warm_s=eval_warm_s, steady_steps_per_s=steady,
        ll=ll, rmse=rmse, calib=calib, general_steady_steps_per_s=general_steady,
        general_twin_launches=general_launches, se_fit_s=se_fit_s, se_eval_s=se_eval_s,
        se_steady_steps_per_s=se_steady, se_ll=se_ll, se_rmse=se_rmse, se_calib=se_calib,
        later_twin_gaps=later_gaps, traces=traces)


def timed_fit(model, n_iter, log_period):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.meta_fit(n_iter=n_iter, log_period=log_period, verbose=False)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase4(profile_dir):
    import numpy as np
    import torch

    from meta_learning_pacoh_torch.ops import cuda

    train, test = sin20()
    model = sin20_model(train)
    if not model._fused_path_ok():
        raise AssertionError("sin_20 does not take the fused path")
    print(f"  sin_20: {len(train)} tasks x {len(train[0][0])} points, {len(test)} test tasks "
          f"x ({len(test[0][0])} context + {len(test[0][2])} test points), "
          f"K={model.num_particles}, P={model.hyper_prior.dim}")
    cuda.reset_launch_counts()
    fit_s = timed_fit(model, SIN_STEPS, SIN_STEPS)
    launches = dict(cuda.LAUNCHES)
    print(f"  meta_fit: {SIN_STEPS} steps in {fit_s:.3f} s ({SIN_STEPS / fit_s:.1f} steps/s, "
          f"first call); launches in the fit: {launches}")
    if launches["fused_svgd"] < 1 or any(launches[k] for k in ("svgd_phi", "mll_fwd",
                                                                "mll_bwd")):
        raise AssertionError(f"the fit was not carried by the fused kernel: {launches}")
    k, (t, n, d) = model.num_particles, model.X.shape
    plan = cluster_report("fused_svgd", k, t, n, d, tuple(model.cfg.mean_nn_layers))
    if plan[0] < 2 or k * plan[0] <= 10:
        raise AssertionError(f"sin_20's B2 runs {k} clusters of {plan[0]} CTAs")
    print(f"  B2 ran {k} clusters of {plan[0]} CTAs, one grid barrier a step, on "
          f"{model.device} (the learner was built without a device)")
    one_chunk = model.particles.clone()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    ll, rmse, calib = model.eval_datasets(test)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_chol_small = cuda.LAUNCHES["chol_small"]
    print(f"  eval_datasets: {len(test)} tasks in {eval_s:.3f} s (first call); "
          f"LL {ll:.6f}, RMSE {rmse:.6f}, calib {calib:.6f}; B5 launches {eval_chol_small}")
    if not all(math.isfinite(v) for v in (ll, rmse, calib)) or not bool(
            torch.isfinite(model.particles).all()):
        raise AssertionError("non-finite particles or metrics")

    steady_s = timed_fit(model, SIN_STEPS, SIN_STEPS)
    steady = SIN_STEPS / steady_s
    print(f"  steady state: {SIN_STEPS} steps in {steady_s:.4f} s, {steady:.1f} steps/s")
    t0 = time.perf_counter()
    model.eval_datasets(test)
    torch.cuda.synchronize()
    eval_warm_s = time.perf_counter() - t0
    print(f"  eval_datasets again: {eval_warm_s:.4f} s")
    traces = {}
    if profile_dir:
        traces["sin20_fit_1000_steps"] = profile(
            "sin20_fit", lambda: model.meta_fit(n_iter=1000, log_period=1000, verbose=False),
            profile_dir)
        traces["sin20_eval"] = profile("sin20_eval", lambda: model.eval_datasets(test),
                                       profile_dir)
        for label, summary in traces.items():
            print(f"  trace {label}: " + json.dumps(summary))

    chunked = sin20_model(train)
    chunked.meta_fit(n_iter=SIN_STEPS, log_period=SIN_CHUNK, verbose=False)
    same = torch.equal(chunked.particles, one_chunk)
    print(f"  chunkings: log_period {SIN_STEPS} and {SIN_CHUNK} give identical particles: "
          f"{same}")
    if not same:
        raise AssertionError("two chunkings of the fused fit differ")

    seeds = {30: (ll, rmse, calib)}
    for seed in SIN_SEEDS[1:]:
        other = sin20_model(train, seed=seed)
        other.meta_fit(n_iter=SIN_STEPS, log_period=SIN_STEPS, verbose=False)
        seeds[seed] = other.eval_datasets(test)
    lls = [seeds[s][0] for s in SIN_SEEDS]
    rmses = [seeds[s][1] for s in SIN_SEEDS]
    mean_ll, mean_rmse = float(np.mean(lls)), float(np.mean(rmses))
    print(f"  seeds {SIN_SEEDS} after {SIN_STEPS} steps: LL {lls}, RMSE {rmses}; mean LL "
          f"{mean_ll:.4f} (band {SIN_LL_BAND[0]} +- {SIN_LL_BAND[1]}), mean RMSE "
          f"{mean_rmse:.4f} (band {SIN_RMSE_BAND[0]} +- {SIN_RMSE_BAND[1]})")
    if not (abs(mean_ll - SIN_LL_BAND[0]) <= SIN_LL_BAND[1]
            and abs(mean_rmse - SIN_RMSE_BAND[0]) <= SIN_RMSE_BAND[1]):
        raise AssertionError("sin_20 accuracy outside the JAX package's band")
    return launches, dict(fit_s=fit_s, steady_s=steady_s, steady_steps_per_s=steady,
                          eval_s=eval_s, eval_warm_s=eval_warm_s,
                          eval_chol_small_launches=eval_chol_small, ll=ll, rmse=rmse,
                          calib=calib, seed_ll=lls, seed_rmse=rmses, mean_ll=mean_ll,
                          mean_rmse=mean_rmse, traces=traces)


def phase5(profile_dir):
    import numpy as np
    import torch

    from meta_learning_pacoh_torch.ops import cuda

    train, test = sin20()
    model = demo_model(train)  # no device: the card by default
    if model.device.type != "cuda" or not model._fused_path_ok():
        raise AssertionError(f"the demo learner is on {model.device}, or off the fused path")
    print(f"  demo: {len(train)} tasks x {len(train[0][0])} points, task batch "
          f"{model.task_batch_size} (count-weighted), P={model.params.numel()}, on {model.device}")
    cuda.reset_launch_counts()
    fit_s = timed_fit(model, MAP_STEPS, MAP_STEPS)
    launches = dict(cuda.LAUNCHES)
    print(f"  meta_fit: {MAP_STEPS} steps in {fit_s:.3f} s ({MAP_STEPS / fit_s:.1f} steps/s, "
          f"first call); launches in the fit: {launches}")
    if launches["fused_map"] < 1 or any(v for k, v in launches.items() if k != "fused_map"):
        raise AssertionError(f"the fit was not carried by the fused MAP kernel: {launches}")
    one_chunk = model.params.clone()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    ll, rmse, calib = model.eval_datasets(test)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_chol_small = cuda.LAUNCHES["chol_small"]
    print(f"  eval_datasets: {len(test)} tasks in {eval_s:.4f} s (first call); "
          f"LL {ll:.6f}, RMSE {rmse:.6f}, calib {calib:.6f}; B5 launches {eval_chol_small}")
    if not all(math.isfinite(v) for v in (ll, rmse, calib)) or not bool(
            torch.isfinite(model.params).all()):
        raise AssertionError("non-finite parameters or metrics")

    steady_s = timed_fit(model, MAP_STEPS, MAP_STEPS)
    steady = MAP_STEPS / steady_s
    print(f"  steady state: {MAP_STEPS} steps in {steady_s:.4f} s, {steady:.1f} steps/s")
    t0 = time.perf_counter()
    model.eval_datasets(test)
    torch.cuda.synchronize()
    eval_warm_s = time.perf_counter() - t0
    print(f"  eval_datasets again: {eval_warm_s:.4f} s")
    x_plot = np.linspace(-5.0, 5.0, 150)
    ucb, lcb = model.confidence_intervals(test[0][0], test[0][1], x_plot, confidence=0.9)
    print(f"  confidence_intervals on test task 0, 150 points: ucb - lcb in "
          f"[{float(np.min(ucb - lcb)):.4f}, {float(np.max(ucb - lcb)):.4f}]")
    if not (ucb.shape == lcb.shape == (150,) and np.all(np.isfinite(ucb))
            and np.all(np.isfinite(lcb)) and np.all(ucb > lcb)):
        raise AssertionError("confidence intervals are not finite with ucb > lcb")
    traces = {}
    if profile_dir:
        traces["demo_fit_1024_steps"] = profile(
            "demo_fit", lambda: model.meta_fit(n_iter=1024, log_period=1024, verbose=False),
            profile_dir)
        traces["demo_eval"] = profile("demo_eval", lambda: model.eval_datasets(test), profile_dir)
        for label, summary in traces.items():
            print(f"  trace {label}: " + json.dumps(summary))

    chunked = demo_model(train)
    chunked.meta_fit(n_iter=MAP_STEPS, log_period=MAP_CHUNK, verbose=False)
    same = torch.equal(chunked.params, one_chunk)
    print(f"  chunkings: log_period {MAP_STEPS} and {MAP_CHUNK} give identical parameters: "
          f"{same}")
    if not same:
        raise AssertionError("two chunkings of the fused fit differ")

    seeds = {30: (ll, rmse, calib)}
    for seed in SIN_SEEDS[1:]:
        other = demo_model(train, seed=seed)
        other.meta_fit(n_iter=MAP_STEPS, log_period=MAP_STEPS, verbose=False)
        seeds[seed] = other.eval_datasets(test)
    lls = [seeds[s][0] for s in SIN_SEEDS]
    rmses = [seeds[s][1] for s in SIN_SEEDS]
    mean_ll, mean_rmse = float(np.mean(lls)), float(np.mean(rmses))
    with open(MAP_BAND_FILE) as f:
        band = json.load(f)["jax_counted"]
    ll_band, rmse_band = band["ll_band"], band["rmse_band"]
    print(f"  seeds {SIN_SEEDS} after {MAP_STEPS} steps: LL {lls}, RMSE {rmses}; mean LL "
          f"{mean_ll:.4f} (band {ll_band[0]:.4f} +- {ll_band[1]:.4f}), mean RMSE "
          f"{mean_rmse:.4f} (band {rmse_band[0]:.4f} +- {rmse_band[1]:.4f})")
    if not (abs(mean_ll - ll_band[0]) <= ll_band[1]
            and abs(mean_rmse - rmse_band[0]) <= rmse_band[1]):
        raise AssertionError("demo accuracy outside the JAX package's band")

    full = demo_model(train, task_batch_size=-1)
    full_first_s = timed_fit(full, MAP_STEPS, MAP_STEPS)
    full_steady_s = timed_fit(full, MAP_STEPS, MAP_STEPS)
    print(f"  full batch (bench.py map_fullbatch): {MAP_STEPS} steps in {full_first_s:.4f} s "
          f"first, {full_steady_s:.4f} s steady ({MAP_STEPS / full_steady_s:.1f} steps/s)")
    return launches, dict(fit_s=fit_s, steady_s=steady_s, steady_steps_per_s=steady,
                          eval_s=eval_s, eval_warm_s=eval_warm_s,
                          eval_chol_small_launches=eval_chol_small, ll=ll, rmse=rmse,
                          calib=calib, seed_ll=lls, seed_rmse=rmses, mean_ll=mean_ll,
                          mean_rmse=mean_rmse, full_batch_first_s=full_first_s,
                          full_batch_steady_s=full_steady_s,
                          full_batch_steps_per_s=MAP_STEPS / full_steady_s, traces=traces)


def phase6(profile_dir):
    import numpy as np
    import torch

    from meta_learning_pacoh_torch.ops import cuda

    train, test = sin20()
    model = vi_model(train)  # no device: the card by default
    if model.device.type != "cuda" or not model._fused_path_ok():
        raise AssertionError(f"the VI learner is on {model.device}, or off the fused path")
    print(f"  sin_20 VI: {len(train)} tasks x {len(train[0][0])} points, S="
          f"{model.svi_batch_size} samples, P={model.hyper_prior.dim}, on {model.device}")
    cuda.reset_launch_counts()
    fit_s = timed_fit(model, VI_STEPS, VI_STEPS)
    launches = dict(cuda.LAUNCHES)
    want_launches = len(list(model._fused.launches(0, VI_STEPS)))
    print(f"  meta_fit: {VI_STEPS} steps in {fit_s:.3f} s ({VI_STEPS / fit_s:.1f} steps/s, "
          f"first call); launches in the fit: {launches}")
    if launches["fused_vi"] != want_launches or any(
            v for k, v in launches.items() if k != "fused_vi"):
        raise AssertionError(f"the fit was not carried by the fused VI kernel alone, one launch "
                             f"per {model._fused.MAX_LAUNCH} steps: {launches}")
    s_, (t, n, d) = model.svi_batch_size, model.X.shape
    plan = cluster_report("fused_vi", s_, t, n, d, tuple(model.cfg.mean_nn_layers))
    if plan[0] < 2 or s_ * plan[0] <= 10:
        raise AssertionError(f"sin_20's B7 runs {s_} clusters of {plan[0]} CTAs")
    one_chunk = {k: v.clone() for k, v in model.posterior.items()}
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    ll, rmse, calib = model.eval_datasets(test)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_chol_small = cuda.LAUNCHES["chol_small"]
    print(f"  eval_datasets: {len(test)} tasks in {eval_s:.4f} s (first call); "
          f"LL {ll:.6f}, RMSE {rmse:.6f}, calib {calib:.6f}; B5 launches {eval_chol_small}")
    if not all(math.isfinite(v) for v in (ll, rmse, calib)) or not all(
            bool(torch.isfinite(v).all()) for v in model.posterior.values()):
        raise AssertionError("non-finite posterior or metrics")

    steady_s = timed_fit(model, VI_STEPS, VI_STEPS)
    steady = VI_STEPS / steady_s
    print(f"  steady state: {VI_STEPS} steps in {steady_s:.4f} s, {steady:.1f} steps/s")
    t0 = time.perf_counter()
    model.eval_datasets(test)
    torch.cuda.synchronize()
    eval_warm_s = time.perf_counter() - t0
    print(f"  eval_datasets again: {eval_warm_s:.4f} s")
    x_plot = np.linspace(-5.0, 5.0, 150)
    ucb, lcb = model.confidence_intervals(test[0][0], test[0][1], x_plot, confidence=0.9)
    print(f"  confidence_intervals on test task 0, 150 points: ucb - lcb in "
          f"[{float(np.min(ucb - lcb)):.4f}, {float(np.max(ucb - lcb)):.4f}]")
    if not (ucb.shape == lcb.shape == (150,) and np.all(np.isfinite(ucb))
            and np.all(np.isfinite(lcb)) and np.all(ucb > lcb)):
        raise AssertionError("confidence intervals are not finite with ucb > lcb")
    traces = {}
    if profile_dir:
        traces["vi_fit_1024_steps"] = profile(
            "vi_fit", lambda: model.meta_fit(n_iter=1024, log_period=1024, verbose=False),
            profile_dir)
        traces["vi_eval"] = profile("vi_eval", lambda: model.eval_datasets(test), profile_dir)
        for label, summary in traces.items():
            print(f"  trace {label}: " + json.dumps(summary))

    chunked = vi_model(train)
    chunked.meta_fit(n_iter=VI_STEPS, log_period=VI_CHUNK, verbose=False)
    same = all(torch.equal(chunked.posterior[k], one_chunk[k]) for k in one_chunk)
    print(f"  chunkings: log_period {VI_STEPS} and {VI_CHUNK} give identical posteriors: {same}")
    if not same:
        raise AssertionError("two chunkings of the fused fit differ")

    os.environ["PACOH_TORCH_DISABLE_FUSED"] = "1"
    try:
        general = vi_model(train)
        if general._fused_path_ok():
            raise AssertionError("PACOH_TORCH_DISABLE_FUSED=1 left the fused path on")
        general.meta_fit(n_iter=5, log_period=5, verbose=False)  # warm-up
        cuda.reset_launch_counts()
        general_s = timed_fit(general, VI_GENERAL_STEPS, VI_GENERAL_STEPS)
    finally:
        os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
    print(f"  general step (PACOH_TORCH_DISABLE_FUSED=1): {VI_GENERAL_STEPS} steps in "
          f"{general_s:.3f} s ({VI_GENERAL_STEPS / general_s:.1f} steps/s); kernel launches "
          f"{dict(cuda.LAUNCHES)}")
    if cuda.LAUNCHES["fused_vi"]:
        raise AssertionError("the general step launched the fused kernel")

    seeds = {30: (ll, rmse, calib)}
    for seed in SIN_SEEDS[1:]:
        other = vi_model(train, seed=seed)
        other.meta_fit(n_iter=VI_STEPS, log_period=VI_STEPS, verbose=False)
        seeds[seed] = other.eval_datasets(test)
    lls = [seeds[s][0] for s in SIN_SEEDS]
    rmses = [seeds[s][1] for s in SIN_SEEDS]
    mean_ll, mean_rmse = float(np.mean(lls)), float(np.mean(rmses))
    with open(VI_BAND_FILE) as f:
        band = json.load(f)["jax"]
    ll_band, rmse_band = band["ll_band"], band["rmse_band"]
    print(f"  seeds {SIN_SEEDS} after {VI_STEPS} steps: LL {lls}, RMSE {rmses}; mean LL "
          f"{mean_ll:.4f} (band {ll_band[0]:.4f} +- {ll_band[1]:.4f}), mean RMSE "
          f"{mean_rmse:.4f} (band {rmse_band[0]:.4f} +- {rmse_band[1]:.4f})")
    if not (abs(mean_ll - ll_band[0]) <= ll_band[1]
            and abs(mean_rmse - rmse_band[0]) <= rmse_band[1]):
        raise AssertionError("sin_20 VI accuracy outside the JAX package's band")
    return launches, dict(fit_s=fit_s, steady_s=steady_s, steady_steps_per_s=steady,
                          eval_s=eval_s, eval_warm_s=eval_warm_s,
                          eval_chol_small_launches=eval_chol_small, ll=ll, rmse=rmse,
                          calib=calib, seed_ll=lls, seed_rmse=rmses, mean_ll=mean_ll,
                          mean_rmse=mean_rmse, general_s=general_s,
                          general_steps_per_s=VI_GENERAL_STEPS / general_s, traces=traces)


def jax_initial_state(ref):
    """The JAX learner's state at step 0 as tools/map_bign_ref.json keeps it,
    in the form of the JAX ``state_dict()`` that ``from_jax_map_state`` reads
    (optax's multi-transform AdamW state, its moments zero)."""
    from types import SimpleNamespace

    import numpy as np

    def arrays(tree, fill=None):
        return {k: arrays(v, fill) if isinstance(v, dict) else
                np.asarray(v, np.float32) * (1.0 if fill is None else fill)
                for k, v in tree.items()}

    params = arrays(ref["init_params"])
    adam = SimpleNamespace(mu=arrays(ref["init_params"], 0.0),
                           nu=arrays(ref["init_params"], 0.0), count=0)
    opt_state = SimpleNamespace(inner_states={"train": SimpleNamespace(inner_state=(adam,))})
    return {"params": params, "opt_state": opt_state, "step": 0}


def phase7(profile_dir):
    import numpy as np
    import torch

    from meta_learning_pacoh_torch import GPRegressionMetaLearnedSVGD
    from meta_learning_pacoh_torch.interop import from_jax_map_state
    from meta_learning_pacoh_torch.models.random_gp import layout_slice
    from meta_learning_pacoh_torch.ops import cuda

    train, test = bign_data()
    model = bign_model(train)  # no device: the card by default
    if model.device.type != "cuda" or not model._fused_path_ok():
        raise AssertionError(f"the map_t5_n200 learner is on {model.device}, or off the fused "
                             f"path")
    print(f"  map_t5_n200: {len(train)} tasks x {len(train[0][0])} points, {len(test)} test "
          f"tasks x ({len(test[0][0])} context + {len(test[0][2])} test points), full batch, "
          f"P={model.params.numel()}, on {model.device}")
    cuda.reset_launch_counts()
    fit_s = timed_fit(model, BIGN_STEPS, BIGN_STEPS)
    launches = dict(cuda.LAUNCHES)
    print(f"  meta_fit: {BIGN_STEPS} steps in {fit_s:.3f} s ({BIGN_STEPS / fit_s:.1f} steps/s, "
          f"first call); launches in the fit: {launches}")
    if launches["fused_map_bign"] < 1 or any(v for k, v in launches.items()
                                             if k != "fused_map_bign"):
        raise AssertionError(f"the fit was not carried by B9 alone: {launches}")
    one_chunk = model.params.clone()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    ll, rmse, calib = model.eval_datasets(test)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    print(f"  eval_datasets: {len(test)} tasks in {eval_s:.4f} s (first call); "
          f"LL {ll:.6f}, RMSE {rmse:.6f}, calib {calib:.6f}; launches {dict(cuda.LAUNCHES)}")
    if not all(math.isfinite(v) for v in (ll, rmse, calib)) or not bool(
            torch.isfinite(model.params).all()):
        raise AssertionError("non-finite parameters or metrics")
    if cuda.LAUNCHES["chol"] < 1:
        raise AssertionError("the eval's 200-point context did not go through K4")

    steady_s = timed_fit(model, BIGN_STEPS, BIGN_STEPS)
    steady = BIGN_STEPS / steady_s
    print(f"  steady state: {BIGN_STEPS} steps in {steady_s:.4f} s, {steady:.1f} steps/s")
    t0 = time.perf_counter()
    model.eval_datasets(test)
    torch.cuda.synchronize()
    eval_warm_s = time.perf_counter() - t0
    print(f"  eval_datasets again: {eval_warm_s:.4f} s")
    x_plot = np.linspace(-5.0, 5.0, 150)
    ucb, lcb = model.confidence_intervals(test[0][0], test[0][1], x_plot, confidence=0.9)
    print(f"  confidence_intervals on test task 0, 150 points: ucb - lcb in "
          f"[{float(np.min(ucb - lcb)):.4f}, {float(np.max(ucb - lcb)):.4f}]")
    if not (ucb.shape == lcb.shape == (150,) and np.all(np.isfinite(ucb))
            and np.all(np.isfinite(lcb)) and np.all(ucb > lcb)):
        raise AssertionError("confidence intervals are not finite with ucb > lcb")
    traces = {}
    if profile_dir:
        traces["bign_fit_100_steps"] = profile(
            "bign_fit", lambda: model.meta_fit(n_iter=100, log_period=100, verbose=False),
            profile_dir)
        traces["bign_eval"] = profile("bign_eval", lambda: model.eval_datasets(test), profile_dir)

    chunked = bign_model(train)
    chunked.meta_fit(n_iter=BIGN_STEPS, log_period=BIGN_CHUNK, verbose=False)
    same = torch.equal(chunked.params, one_chunk)
    print(f"  chunkings: log_period {BIGN_STEPS} and {BIGN_CHUNK} give identical parameters: "
          f"{same}")
    if not same:
        raise AssertionError("two chunkings of the fused fit differ")

    # B9 and the general step (B4) from one state
    state = bign_model(train).state_dict()
    skip = layout_slice(model.layout, ("kernel_nn", "b_out"))
    twins = {}
    for label, disabled in (("fused", "0"), ("general", "1")):
        os.environ["PACOH_TORCH_DISABLE_FUSED"] = disabled
        try:
            twin = bign_model(train)
            twin.load_state_dict(state)
            if twin._fused_path_ok() != (label == "fused"):
                raise AssertionError(f"PACOH_TORCH_DISABLE_FUSED={disabled}: wrong path")
            cuda.reset_launch_counts()
            twin_s = timed_fit(twin, BIGN_TWIN_STEPS, BIGN_TWIN_STEPS)
            twin_launches = dict(cuda.LAUNCHES)
            twins[label] = (twin, twin_s, twin_launches)
        finally:
            os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
    general, general_s, general_launches = twins["general"]
    fused = twins["fused"][0]
    print(f"  general step (PACOH_TORCH_DISABLE_FUSED=1): {BIGN_TWIN_STEPS} steps in "
          f"{general_s:.3f} s ({BIGN_TWIN_STEPS / general_s:.1f} steps/s, first call); "
          f"launches {general_launches}")
    if not (general_launches["blocked_fwd"] > 0 and general_launches["blocked_bwd"] > 0
            and general_launches["fused_map_bign"] == 0):
        raise AssertionError(f"the general step did not run through B4: {general_launches}")
    d_max, d_mean = diff_excluding(fused.params.cpu(), general.params.cpu(), skip)
    rel = [diff_excluding(a.cpu(), b.cpu(), skip)[0] / float(b.abs().max())
           for a, b in ((fused._mu, general._mu), (fused._nu, general._nu))]
    print(f"  B9 against the general step, {BIGN_TWIN_STEPS} steps from one state: |param "
          f"diff| max {d_max:.3e}, mean {d_mean:.3e}; AdamW m, v max diff / max |general| "
          f"{rel[0]:.3e}, {rel[1]:.3e} (kernel_nn.b_out excluded)")
    if not (d_max <= TWIN_ATOL and d_mean <= TWIN_MEAN_ATOL and max(rel) <= B2_MOMENT_RTOL):
        raise AssertionError("B9 and the general step disagree")
    fused_loss = fused.meta_fit(n_iter=1, log_period=1, verbose=False)
    os.environ["PACOH_TORCH_DISABLE_FUSED"] = "1"
    try:
        general_loss = general.meta_fit(n_iter=1, log_period=1, verbose=False)
        general_steady_s = timed_fit(general, BIGN_TWIN_STEPS, BIGN_TWIN_STEPS)
        if profile_dir:
            traces["bign_general_5_steps"] = profile(
                "bign_general", lambda: general.meta_fit(n_iter=5, log_period=5, verbose=False),
                profile_dir)
    finally:
        os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
    loss_rel = abs(fused_loss - general_loss) / abs(general_loss)
    print(f"  the next step's loss: B9 {fused_loss:.7f}, general {general_loss:.7f} (rel diff "
          f"{loss_rel:.3e})")
    if not loss_rel <= B6_LOSS_RTOL:
        raise AssertionError("B9 and the general step disagree in the loss")
    print(f"  general step, steady: {BIGN_TWIN_STEPS / general_steady_s:.1f} steps/s")

    # the JAX learner's run (tools/map_bign_ref.json) from its initial parameters
    with open(BIGN_REF_FILE) as f:
        ref = json.load(f)
    from_jax = bign_model(train)
    from_jax.load_state_dict(from_jax_map_state(jax_initial_state(ref)))
    every = ref["config"]["log_every"]
    got = [from_jax.meta_fit(n_iter=every, log_period=every, verbose=False)
           for _ in range(ref["config"]["steps"] // every)]
    tol = ref["tolerance"]
    loss_gap = max(abs(g - w) / abs(w) for g, w in zip(got, ref["losses"]))
    p_max, p_mean = diff_excluding(from_jax.params.cpu(), torch.tensor(ref["final_params"]),
                                   skip)
    print(f"  from the JAX initial parameters, {ref['config']['steps']} B9 steps: losses "
          f"{[round(v, 6) for v in got]}; max rel gap to the JAX run {loss_gap:.3e} "
          f"(tolerance {tol['loss_rtol']:.3e}); final |param diff| max {p_max:.3e} "
          f"({tol['param_atol']:.3e}), mean {p_mean:.3e} ({tol['param_mean_atol']:.3e})")
    if not (loss_gap <= tol["loss_rtol"] and p_max <= tol["param_atol"]
            and p_mean <= tol["param_mean_atol"]):
        raise AssertionError("the B9 fit disagrees with the JAX learner's")

    # bench.py's svgd_t5_n200 (bench.py:166-168) through its general step (its
    # default path is B10, phase 9)
    os.environ["PACOH_TORCH_DISABLE_FUSED"] = "1"
    try:
        svgd = GPRegressionMetaLearnedSVGD(train, num_iter_fit=BIGN_STEPS, num_particles=10,
                                           random_seed=1, prior_factor=0.01, task_batch_size=-1)
        if svgd._fused_path_ok():
            raise AssertionError("PACOH_TORCH_DISABLE_FUSED=1: svgd_t5_n200 took a fused path")
        cuda.reset_launch_counts()
        svgd_s = timed_fit(svgd, BIGN_TWIN_STEPS, BIGN_TWIN_STEPS)
        svgd_launches = dict(cuda.LAUNCHES)
        svgd_steady_s = timed_fit(svgd, BIGN_TWIN_STEPS, BIGN_TWIN_STEPS)
    finally:
        os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
    print(f"  svgd_t5_n200 general step: {BIGN_TWIN_STEPS} steps in {svgd_s:.3f} s first, "
          f"{svgd_steady_s:.3f} s steady ({BIGN_TWIN_STEPS / svgd_steady_s:.1f} steps/s); "
          f"launches {svgd_launches}")
    if not (svgd_launches["blocked_fwd"] > 0 and svgd_launches["blocked_bwd"] > 0):
        raise AssertionError(f"svgd_t5_n200's general step did not run through B4: "
                             f"{svgd_launches}")
    if not bool(torch.isfinite(svgd.particles).all()):
        raise AssertionError("non-finite svgd_t5_n200 particles")
    for label, summary in traces.items():
        print(f"  trace {label}: " + json.dumps(summary))
    launches.update(blocked_fwd=general_launches["blocked_fwd"],
                    blocked_bwd=general_launches["blocked_bwd"])
    return launches, dict(fit_s=fit_s, steady_s=steady_s, steady_steps_per_s=steady,
                          eval_s=eval_s, eval_warm_s=eval_warm_s, ll=ll, rmse=rmse,
                          calib=calib, twin_max=d_max, twin_mean=d_mean,
                          general_s=general_s, general_steady_steps_per_s=BIGN_TWIN_STEPS
                          / general_steady_s, jax_loss_gap=loss_gap, jax_param_max=p_max,
                          svgd_general_steady_steps_per_s=BIGN_TWIN_STEPS / svgd_steady_s,
                          svgd_launches=svgd_launches, traces=traces)


def phase8(profile_dir):
    import numpy as np
    import torch

    from meta_learning_pacoh_torch.ops import cuda

    train, test = sin20()
    model = mlap_model(train)  # no device: the card by default
    if model.device.type != "cuda" or not model._fused_path_ok():
        raise AssertionError(f"the MLAP learner is on {model.device}, or off the fused path")
    print(f"  sin_20 MLAP: {len(train)} tasks x {len(train[0][0])} points, S="
          f"{model.svi_batch_size} samples, P={model.hyper_prior.dim}, on {model.device}")
    cuda.reset_launch_counts()
    fit_s = timed_fit(model, MLAP_STEPS, MLAP_STEPS)
    launches = dict(cuda.LAUNCHES)
    want_launches = len(list(model._fused.launches(0, MLAP_STEPS)))
    print(f"  meta_fit: {MLAP_STEPS} steps in {fit_s:.3f} s ({MLAP_STEPS / fit_s:.1f} steps/s, "
          f"first call); launches in the fit: {launches}")
    if launches["fused_mlap"] != want_launches or any(
            v for k, v in launches.items() if k != "fused_mlap"):
        raise AssertionError(f"the fit was not carried by B8 alone, one launch per "
                             f"{model._fused.MAX_LAUNCH} steps: {launches}")
    one_chunk = {k: v.clone() for k, v in model.params.items()}
    if not all(bool(torch.isfinite(v).all()) for v in one_chunk.values()):
        raise AssertionError("non-finite MLAP state after the fit")
    steady_s = timed_fit(model, MLAP_STEPS, MLAP_STEPS)
    steady = MLAP_STEPS / steady_s
    print(f"  steady state: {MLAP_STEPS} steps in {steady_s:.4f} s, {steady:.1f} steps/s")

    # bench.py's meta-test row: 5 context sets, two warm calls, then 5 timed
    ctx = [t[:2] for t in test[:5]]
    for _ in range(2):
        model._meta_test_inference(ctx, n_iter=MLAP_META_TEST)
    mt_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = model._meta_test_inference(ctx, n_iter=MLAP_META_TEST)
        float(state["q_means"].reshape(-1)[0])
        mt_s.append((time.perf_counter() - t0) / len(ctx))
    print(f"  meta-test ({MLAP_META_TEST} steps, {len(ctx)} tasks): "
          f"{statistics.mean(mt_s):.5f} s a task (mean of 5; {[round(v, 5) for v in mt_s]})")

    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    ll, rmse, calib = model.eval_datasets(test)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = dict(cuda.LAUNCHES)
    print(f"  eval_datasets: {len(test)} tasks in {eval_s:.4f} s (first call, a {MLAP_META_TEST}"
          f"-step meta-test); LL {ll:.6f}, RMSE {rmse:.6f}, calib {calib:.6f}; launches "
          f"{eval_launches}")
    if not (eval_launches["fused_mlap"] > 0 and eval_launches["chol_small"] > 0):
        raise AssertionError(f"the eval did not run through B8 and B5: {eval_launches}")
    if not all(math.isfinite(v) for v in (ll, rmse, calib)):
        raise AssertionError("non-finite metrics")
    t0 = time.perf_counter()
    model.eval_datasets(test)
    torch.cuda.synchronize()
    eval_warm_s = time.perf_counter() - t0
    print(f"  eval_datasets again: {eval_warm_s:.4f} s")
    x_plot = np.linspace(-5.0, 5.0, 150)
    ucb, lcb = model.confidence_intervals(test[0][0], test[0][1], x_plot, confidence=0.9,
                                          n_iter_meta_test=MLAP_CI_META_TEST)
    print(f"  confidence_intervals on test task 0, 150 points, a {MLAP_CI_META_TEST}-step "
          f"meta-test: ucb - lcb in [{float(np.min(ucb - lcb)):.4f}, "
          f"{float(np.max(ucb - lcb)):.4f}]")
    if not (ucb.shape == lcb.shape == (150,) and np.all(np.isfinite(ucb))
            and np.all(np.isfinite(lcb)) and np.all(ucb > lcb)):
        raise AssertionError("confidence intervals are not finite with ucb > lcb")
    traces = {}
    if profile_dir:
        traces["mlap_fit_512_steps"] = profile(
            "mlap_fit", lambda: model.meta_fit(n_iter=512, log_period=512, verbose=False),
            profile_dir)
        traces["mlap_eval"] = profile("mlap_eval", lambda: model.eval_datasets(test), profile_dir)
        for label, summary in traces.items():
            print(f"  trace {label}: " + json.dumps(summary))

    chunked = mlap_model(train)
    chunked.meta_fit(n_iter=MLAP_STEPS, log_period=MLAP_CHUNK, verbose=False)
    same = all(torch.equal(chunked.params[k], one_chunk[k]) for k in one_chunk)
    print(f"  chunkings: log_period {MLAP_STEPS} and {MLAP_CHUNK} give identical states: {same}")
    if not same:
        raise AssertionError("two chunkings of the fused fit differ")

    # B8 and the general step from one well-conditioned state and one set of
    # draws (at the sin_20 learner's own state the inner gram is singular to
    # float32, and any two float32 orders part within a few steps)
    rs = np.random.RandomState(12)
    tasks = conditioned_tasks(rs, 20, 5)
    state = conditioned_state(mlap_model(tasks), rs)
    twins = {}
    for label, disabled in (("fused", "0"), ("general", "1")):
        os.environ["PACOH_TORCH_DISABLE_FUSED"] = disabled
        try:
            twin = mlap_model(tasks)
            twin.load_state_dict(state)
            if twin._fused_path_ok() != (label == "fused"):
                raise AssertionError(f"PACOH_TORCH_DISABLE_FUSED={disabled}: wrong path")
            cuda.reset_launch_counts()
            twin_s = timed_fit(twin, MLAP_TWIN_STEPS, MLAP_TWIN_STEPS)
            twins[label] = (twin, twin_s, dict(cuda.LAUNCHES))
        finally:
            os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
    general, general_s, general_launches = twins["general"]
    fused = twins["fused"][0]
    print(f"  general step (PACOH_TORCH_DISABLE_FUSED=1): {MLAP_TWIN_STEPS} steps in "
          f"{general_s:.3f} s ({MLAP_TWIN_STEPS / general_s:.1f} steps/s, first call); launches "
          f"{general_launches}")
    if general_launches["fused_mlap"]:
        raise AssertionError("the general step launched the fused kernel")
    skip = fused.hyper_prior.slice_of(("kernel_nn", "b_out"))
    fused_loss = fused.meta_fit(n_iter=1, log_period=1, verbose=False)[0]
    os.environ["PACOH_TORCH_DISABLE_FUSED"] = "1"
    try:
        general_loss = general.meta_fit(n_iter=1, log_period=1, verbose=False)[0]
        twin_max = compare_mlap(f"B8 against the general step, {MLAP_TWIN_STEPS} steps from one "
                                f"state and the next step's loss", mlap_state(fused),
                                mlap_state(general), fused_loss, general_loss, skip)
        general_steady_s = timed_fit(general, MLAP_TWIN_STEPS, MLAP_TWIN_STEPS)
    finally:
        os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
    print(f"  general step, steady: {MLAP_TWIN_STEPS / general_steady_s:.1f} steps/s")

    seeds = {}
    for seed in SIN_SEEDS:
        other = mlap_model(train, seed=seed)
        other.meta_fit(n_iter=MLAP_STEPS, log_period=MLAP_STEPS, verbose=False)
        seeds[seed] = other.eval_datasets(test)
    lls = [seeds[s][0] for s in SIN_SEEDS]
    rmses = [seeds[s][1] for s in SIN_SEEDS]
    mean_ll, mean_rmse = float(np.mean(lls)), float(np.mean(rmses))
    with open(MLAP_BAND_FILE) as f:
        band = json.load(f)["jax"]
    ll_band, rmse_band = band["ll_band"], band["rmse_band"]
    print(f"  seeds {SIN_SEEDS} after {MLAP_STEPS} steps: LL {lls}, RMSE {rmses}; mean LL "
          f"{mean_ll:.4f} (band {ll_band[0]:.4f} +- {ll_band[1]:.4f}), mean RMSE "
          f"{mean_rmse:.4f} (band {rmse_band[0]:.4f} +- {rmse_band[1]:.4f})")
    if not (abs(mean_ll - ll_band[0]) <= ll_band[1]
            and abs(mean_rmse - rmse_band[0]) <= rmse_band[1]):
        raise AssertionError("sin_20 MLAP accuracy outside the JAX package's band")
    launches.update(chol_small=eval_launches["chol_small"])
    return launches, dict(fit_s=fit_s, steady_s=steady_s, steady_steps_per_s=steady,
                          meta_test_s_per_task=statistics.mean(mt_s), eval_s=eval_s,
                          eval_warm_s=eval_warm_s, ll=ll, rmse=rmse, calib=calib,
                          twin_max=twin_max, general_s=general_s,
                          general_steady_steps_per_s=MLAP_TWIN_STEPS / general_steady_s,
                          seed_ll=lls, seed_rmse=rmses, mean_ll=mean_ll, mean_rmse=mean_rmse,
                          traces=traces)


def svgd_state(model):
    """The SVGD learner's particles and Adam moments (the particles first)."""
    return [model.particles, model._mu, model._nu]


def vi_live_state(model):
    """The VI learner's loc, log_scale and their Adam moments (loc, log_scale first)."""
    return [tree[k] for tree in (model.posterior, model._mu, model._nu)
            for k in ("loc", "log_scale")]


def svgd_plain64(model, state, n_steps=BIGN_TWIN_STEPS, dtype="float64"):
    """n_steps of B10's plain version in float64 (or ``dtype``) from an SVGD
    learner's state_dict() (its particles, Adam moments and step), on its
    data, with the learner's launches and learning rates (full batch)."""
    import torch

    from meta_learning_pacoh_torch.ops import launch_sched
    from meta_learning_pacoh_torch.ops.cuda import fused_svgd_bign_kernel as sb

    dt = getattr(torch, dtype)
    theta, mu, nu = (torch.tensor(a, dtype=dt, device=model.device) for a in (
        state["particles"], state["opt_state"]["mu"], state["opt_state"]["nu"]))
    tr = model._fused
    if tr.counted:
        raise ValueError("svgd_plain64: a full-batch learner only")
    for s0, sub in tr.launches(int(state["step"]), n_steps):
        sb.fused_svgd_bign_train_ref(
            theta, mu, nu, *(t.to(dt) for t in data_of(model)), tr.w_t, s0,
            launch_sched.staircase_lr(tr.lr, tr.lr_decay, s0), model.prior_factor,
            hidden=tr.hidden, wps=model._weight_prior_std, bps=model._bias_prior_std,
            n_steps=sub)
    return [theta, mu, nu]


def vi_plain64(model, state):
    """As ``svgd_plain64``, B11's plain version from a VI learner's state, fed
    the learner's own noise pages."""
    from meta_learning_pacoh_torch.ops.cuda import fused_vi_bign_kernel as vb

    loc, lsc = (float64_tensor(state["posterior"][k], model.device) for k in ("loc", "log_scale"))
    moments = [loc.new_zeros(loc.shape) for _ in range(4)]
    tr = model._fused
    vb.fused_vi_bign_train_ref(
        loc, lsc, *moments, *(t.double() for t in data_of(model)), tr.w_t,
        tr.eps_pages(0, BIGN_TWIN_STEPS).double(), 0, model._lr, model.prior_factor,
        hidden=tr.hidden, wps=model._weight_prior_std, bps=model._bias_prior_std,
        mll_const=tr.mll_const, n_steps=BIGN_TWIN_STEPS)
    return [loc, lsc, moments[0], moments[1], moments[2], moments[3]]


def float64_tensor(array, device):
    import torch

    return torch.tensor(array, dtype=torch.float64, device=device)


def bign_learner_path(label, build, state_of, n_params, counter, trainer_cls, general_kernels,
                      plain64, train, test, profile_dir):
    """One big-N learner's main path on the card (phase 9): the fit carried by
    its fused kernel alone, the eval through K4, two chunkings, 20 steps
    against the general step and the plain version in float64 from the
    initial states of BIGN_DRIFT_SEEDS (``bign_twins``), the faceoff of the
    two steady rates, which must agree with the learner's dispatch, and the
    mean test LL and RMSE of seeds 30-32 in the JAX learner's band."""
    import torch

    from meta_learning_pacoh_torch.ops import cuda

    model = build(train)  # no device: the card by default
    if model.device.type != "cuda" or not model._fused_path_ok():
        raise AssertionError(f"the {label} learner is on {model.device}, or off the fused path")
    cuda.reset_launch_counts()
    fit_s = timed_fit(model, BIGN_STEPS, BIGN_STEPS)
    launches = dict(cuda.LAUNCHES)
    print(f"  {label} meta_fit: {BIGN_STEPS} steps in {fit_s:.3f} s "
          f"({BIGN_STEPS / fit_s:.1f} steps/s, first call); launches in the fit: {launches}")
    if (launches[counter] < 1 or any(v for k, v in launches.items() if k != counter)
            or type(model._fused) is not trainer_cls):
        raise AssertionError(f"the {label} fit was not carried by {counter} alone: {launches}")
    one_chunk = [t.clone() for t in state_of(model)]
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    ll, rmse, calib = model.eval_datasets(test)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    print(f"  {label} eval_datasets: {len(test)} tasks in {eval_s:.4f} s (first call); LL "
          f"{ll:.6f}, RMSE {rmse:.6f}, calib {calib:.6f}; launches {dict(cuda.LAUNCHES)}")
    if not all(math.isfinite(v) for v in (ll, rmse, calib)) or not all(
            bool(torch.isfinite(t).all()) for t in one_chunk):
        raise AssertionError(f"{label}: non-finite state or metrics")
    if cuda.LAUNCHES["chol"] < 1:
        raise AssertionError(f"{label}: the eval's 200-point context did not go through K4")
    steady_s = timed_fit(model, BIGN_STEPS, BIGN_STEPS)
    steady = BIGN_STEPS / steady_s
    t0 = time.perf_counter()
    model.eval_datasets(test)
    torch.cuda.synchronize()
    eval_warm_s = time.perf_counter() - t0
    print(f"  {label} steady state: {BIGN_STEPS} steps in {steady_s:.4f} s, {steady:.1f} "
          f"steps/s; eval_datasets again {eval_warm_s:.4f} s")
    traces = {}
    if profile_dir:
        traces[f"{label}_fit_100_steps"] = profile(
            f"{label}_fit", lambda: model.meta_fit(n_iter=100, log_period=100, verbose=False),
            profile_dir)

    chunked = build(train)
    chunked.meta_fit(n_iter=BIGN_STEPS, log_period=BIGN_CHUNK, verbose=False)
    same = all(torch.equal(a, b) for a, b in zip(state_of(chunked), one_chunk))
    print(f"  {label} chunkings: log_period {BIGN_STEPS} and {BIGN_CHUNK} give identical "
          f"parameters and moments: {same}")
    if not same:
        raise AssertionError(f"{label}: two chunkings of the fused fit differ")

    # the fused kernel, the general step and the plain version in float64 from
    # the initial states of BIGN_DRIFT_SEEDS; the first seed's twins go on
    limits = BIGN_GENERAL_F64[label]
    for seed in BIGN_DRIFT_SEEDS:
        fused, general, general_launches, general_s, f64, g64, fg = bign_twins(
            build, state_of, n_params, plain64, train, seed)
        print(f"  {label}, seed {seed}, {BIGN_TWIN_STEPS} steps from the initial state "
              f"(|param diff| max, mean; Adam m, v max diff / max; kernel_nn.b_out excluded): "
              f"fused - plain float64 {f64[0]:.3e}, {f64[1]:.3e}, {f64[2]:.3e}; general - plain "
              f"float64 {g64[0]:.3e}, {g64[1]:.3e}, {g64[2]:.3e}; fused - general {fg[0]:.3e}, "
              f"{fg[1]:.3e}, {fg[2]:.3e}")
        if not (f64[0] <= TWIN_ATOL and f64[1] <= TWIN_MEAN_ATOL and f64[2] <= B2_MOMENT_RTOL):
            raise AssertionError(f"{label}, seed {seed}: the fused kernel disagrees with its "
                                 f"plain version in float64")
        if not all(g <= lim for g, lim in zip(g64, limits)):
            raise AssertionError(f"{label}, seed {seed}: the general step drifted farther than "
                                 f"{limits} from the float64 run")
        if seed == BIGN_DRIFT_SEEDS[0]:
            twin_gaps = dict(twin_max=fg[0], twin_mean=fg[1], fused_f64_max=f64[0],
                             general_f64_max=g64[0])
            first = fused, general, general_launches, general_s
    fused, general, general_launches, general_s = first
    print(f"  {label} general step (PACOH_TORCH_DISABLE_FUSED=1): {BIGN_TWIN_STEPS} steps in "
          f"{general_s:.3f} s (first call); launches {general_launches}")
    if not (all(general_launches[k] > 0 for k in general_kernels)
            and general_launches[counter] == 0):
        raise AssertionError(f"{label}: the general step did not run through "
                             f"{general_kernels}: {general_launches}")
    fused_loss = fused.meta_fit(n_iter=1, log_period=1, verbose=False)
    os.environ["PACOH_TORCH_DISABLE_FUSED"] = "1"
    try:
        general_loss = general.meta_fit(n_iter=1, log_period=1, verbose=False)
        general_steady = BIGN_TWIN_STEPS / timed_fit(general, BIGN_TWIN_STEPS, BIGN_TWIN_STEPS)
        if profile_dir:
            traces[f"{label}_general_5_steps"] = profile(
                f"{label}_general",
                lambda: general.meta_fit(n_iter=5, log_period=5, verbose=False), profile_dir)
    finally:
        os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
    if fused_loss is not None:  # VI: the next step's loss on both paths
        loss_rel = abs(fused_loss - general_loss) / abs(general_loss)
        print(f"  {label}: the next step's loss: fused {fused_loss:.7f}, general "
              f"{general_loss:.7f} (rel diff {loss_rel:.3e})")
        if not loss_rel <= B6_LOSS_RTOL:
            raise AssertionError(f"{label}: the fused kernel and the general step disagree "
                                 f"in the loss")
    print(f"  {label} faceoff: fused {steady:.1f} steps/s, general step {general_steady:.1f} "
          f"steps/s ({steady / general_steady:.2f}x); the learner's dispatch: fused")
    if not steady > general_steady:
        raise AssertionError(f"{label}: the learner's big-N dispatch (fused) disagrees with the "
                             f"faceoff")
    for name, summary in traces.items():
        print(f"  trace {name}: " + json.dumps(summary))

    # seeds 30-32 of the default path against the JAX learner's band
    with open(BIGN_BAND_FILE) as f:
        band = json.load(f)[label]["jax"]
    lls, rmses = [], []
    for seed in SIN_SEEDS:
        fit = build(train, seed=seed)
        fit.meta_fit(n_iter=BIGN_STEPS, log_period=BIGN_STEPS, verbose=False)
        seed_ll, seed_rmse, _ = fit.eval_datasets(test)
        lls.append(seed_ll)
        rmses.append(seed_rmse)
    mean_ll, mean_rmse = statistics.fmean(lls), statistics.fmean(rmses)
    (ll_c, ll_m), (rmse_c, rmse_m) = band["ll_band"], band["rmse_band"]
    print(f"  {label} seeds {SIN_SEEDS}: LL {lls}, RMSE {rmses}; mean LL {mean_ll:.4f} (JAX band "
          f"{ll_c:.4f} +- {ll_m:.4f}), mean RMSE {mean_rmse:.4f} ({rmse_c:.4f} +- {rmse_m:.4f})")
    if not (abs(mean_ll - ll_c) <= ll_m and abs(mean_rmse - rmse_c) <= rmse_m):
        raise AssertionError(f"{label}: seeds {SIN_SEEDS} lie outside the JAX learner's band")
    return launches[counter], dict(fit_s=fit_s, steady_s=steady_s, steady_steps_per_s=steady,
                                   eval_s=eval_s, eval_warm_s=eval_warm_s, ll=ll, rmse=rmse,
                                   calib=calib, **twin_gaps,
                                   general_steady_steps_per_s=general_steady,
                                   speedup=steady / general_steady, seed_ll=lls,
                                   seed_rmse=rmses, mean_ll=mean_ll, mean_rmse=mean_rmse,
                                   traces=traces)


def bign_twins(build, state_of, n_params, plain64, train, seed):
    """BIGN_TWIN_STEPS steps of a big-N learner from its initial state at
    ``seed``: through its fused kernel, through its general step
    (``PACOH_TORCH_DISABLE_FUSED=1``; VI with the same noise) and through the
    kernel's plain version in float64. Returns the fused and the general
    learner, the general step's launches and first-call seconds, and the
    gaps (``gaps``) fused - float64, general - float64, fused - general."""
    from meta_learning_pacoh_torch.ops import cuda

    state = build(train, seed=seed).state_dict()
    twins = {}
    for path, disabled in (("fused", "0"), ("general", "1")):
        os.environ["PACOH_TORCH_DISABLE_FUSED"] = disabled
        try:
            twin = build(train, seed=seed)
            twin.load_state_dict(state)
            if twin._fused_path_ok() != (path == "fused"):
                raise AssertionError(f"PACOH_TORCH_DISABLE_FUSED={disabled}: wrong path")
            cuda.reset_launch_counts()
            twin_s = timed_fit(twin, BIGN_TWIN_STEPS, BIGN_TWIN_STEPS)
            twins[path] = (twin, twin_s, dict(cuda.LAUNCHES))
        finally:
            os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
    fused, general = twins["fused"][0], twins["general"][0]
    skip = fused.hyper_prior.slice_of(("kernel_nn", "b_out"))
    wide = plain64(fused, state)
    return (fused, general, twins["general"][2], twins["general"][1],
            gaps(state_of(fused), wide, n_params, skip),
            gaps(state_of(general), wide, n_params, skip),
            gaps(state_of(fused), state_of(general), n_params, skip))


def faceoff_tasks(n_tasks, n_points):
    """A faceoff shape's tasks: cauchy_20's (``n_tasks`` None), else bench.py's
    sinusoid environment (RandomState(5)) at that many tasks and points."""
    import numpy as np

    from meta_learning_pacoh_torch.datasets import SinusoidDataset

    if n_tasks is None:
        return cauchy20()[0]
    env = SinusoidDataset(random_state=np.random.RandomState(5))
    return env.generate_meta_train_data(n_tasks=n_tasks, n_samples=n_points)


def steady_rate(model, cap):
    """Steps/s of a learner's fit after a warm call: about FACEOFF_SECONDS of
    steps (5 to ``cap``), sized by a 5-step call."""
    timed_fit(model, 2, 2)
    per_step = timed_fit(model, 5, 5) / 5
    n = max(5, min(cap, int(FACEOFF_SECONDS / per_step)))
    return n / timed_fit(model, n, n)


def bign_faceoff(label, build):
    """The big-N dispatch's faceoff at the BIGN_FACEOFF shapes: the learner's
    steady rate on its fused kernel (``PACOH_TORCH_FORCE_BIGN_FUSED=1``)
    against its general step's (``PACOH_TORCH_DISABLE_FUSED=1``), beside the
    learner's default dispatch (``bign_wins``). Returns one row a shape."""
    rows = []
    for name, n_tasks, n_points in BIGN_FACEOFF:
        tasks = faceoff_tasks(n_tasks, n_points)
        default = build(tasks)._fused_path_ok()
        rates = {}
        for path, switch in (("fused", "PACOH_TORCH_FORCE_BIGN_FUSED"),
                             ("general", "PACOH_TORCH_DISABLE_FUSED")):
            os.environ[switch] = "1"
            try:
                model = build(tasks)
                if model._fused_path_ok() != (path == "fused"):
                    raise AssertionError(f"{label} faceoff, {name}: {switch}=1 took the wrong "
                                         f"path")
                rates[path] = steady_rate(model, 2000 if path == "fused" else 200)
            finally:
                os.environ.pop(switch)
        t, n, _ = model.X.shape
        g = 10 * t
        ratio = rates["fused"] / rates["general"]
        print(f"  {label} faceoff, {name} (N={n}, G={g}): fused {rates['fused']:.1f} steps/s, "
              f"general step {rates['general']:.1f} ({ratio:.2f}x); the learner's dispatch: "
              f"{'fused' if default else 'general step'}", flush=True)
        rows.append(dict(shape=name, n=n, g=g, fused=rates["fused"], general=rates["general"],
                         speedup=ratio, default_fused=default))
    return rows


def phase9(profile_dir):
    import torch

    from meta_learning_pacoh_torch.ops.cuda import fused_svgd_bign_kernel as sb
    from meta_learning_pacoh_torch.ops.cuda import fused_vi_bign_kernel as vb

    train, test = bign_data()
    print(f"  {len(train)} tasks x {len(train[0][0])} points, {len(test)} test tasks x "
          f"({len(test[0][0])} context + {len(test[0][2])} test points), full batch, seed 1")
    launches, summaries = {}, {}
    launches["fused_svgd_bign"], summaries["svgd_t5_n200"] = bign_learner_path(
        "svgd_t5_n200", bign_svgd_model, svgd_state, 1, "fused_svgd_bign",
        sb.FusedSVGDBigNTrainer, ("blocked_fwd", "blocked_bwd", "svgd_phi"), svgd_plain64, train,
        test, profile_dir)
    launches["fused_vi_bign"], summaries["vi_t5_n200"] = bign_learner_path(
        "vi_t5_n200", bign_vi_model, vi_live_state, 2, "fused_vi_bign", vb.FusedVIBigNTrainer,
        ("blocked_fwd", "blocked_bwd"), vi_plain64, train, test, profile_dir)

    # the JAX learner's svgd_t5_n200 run (tools/svgd_bign_ref.json) from its initial particles
    with open(SVGD_BIGN_REF_FILE) as f:
        ref = json.load(f)
    from_jax = bign_svgd_model(train)
    init = ref["init_particles"]
    zeros = [[0.0] * len(init[0])] * len(init)
    from_jax.load_state_dict({"particles": init, "opt_state": {"mu": zeros, "nu": zeros,
                                                               "count": 0}, "step": 0})
    steps = ref["config"]["steps"]
    from_jax.meta_fit(n_iter=steps, log_period=steps, verbose=False)
    skip = from_jax.hyper_prior.slice_of(("kernel_nn", "b_out"))
    tol = ref["tolerance"]
    p_max, p_mean = diff_excluding(from_jax.particles.cpu(),
                                   torch.tensor(ref["final_particles"]), skip)
    print(f"  svgd_t5_n200 from the JAX initial particles, {steps} B10 steps: final |particle "
          f"diff| to the JAX run max {p_max:.3e} (tolerance {tol['particle_atol']:.3e}), mean "
          f"{p_mean:.3e} ({tol['particle_mean_atol']:.3e})")
    if not (p_max <= tol["particle_atol"] and p_mean <= tol["particle_mean_atol"]):
        raise AssertionError("the B10 fit disagrees with the JAX learner's")
    summaries["svgd_t5_n200"].update(jax_particle_max=p_max, jax_particle_mean=p_mean)

    # the dispatch policy beyond the main path's shape
    for label, build in (("svgd_t5_n200", bign_svgd_model), ("vi_t5_n200", bign_vi_model)):
        rows = bign_faceoff(label.split("_")[0].upper(), build)
        summaries[label]["faceoff"] = rows
        for row in rows:
            if row["default_fused"] != (row["speedup"] > 1.0):
                raise AssertionError(f"{label} faceoff, {row['shape']}: the learner's big-N "
                                     f"dispatch disagrees with the faceoff")
    return launches, summaries


def single_steps(name):
    return CUSTOM_MAP_STEPS if name == "custom_map_t5_n200" else SINGLE_STEPS


def single_expected(name, n_evals):
    """The launches a phase-10 fit of ``name`` must count, by kernel: its
    steps' kernels once (B4, K2/K3) or three times (GPR-PAC's K4) a step,
    and K4 in each of its ``n_evals`` validation evals (the predictive's
    factor at 200 context points, once or, GPR-PAC's safe_cholesky, three
    times, and the four of mvn_log_prob's escalation at 200 test points)."""
    steps = single_steps(name)
    if name == "gpr_mll_n20":
        want = {"mll_fwd": steps, "mll_bwd": steps}
    elif name == "gpr_pac_n200":
        want = {"chol": 3 * steps}
    else:
        want = {"blocked_fwd": steps, "blocked_bwd": steps}
    if n_evals:
        want["chol"] = want.get("chol", 0) + n_evals * single_eval_launches(name)
    return want


def single_eval_launches(name):
    """K4's launches in one eval of ``name`` (custom_map_t5_n200: of
    eval_datasets on its 20 test tasks, one batched factor and four levels)."""
    return {"gpr_mll_n20": 4, "gpr_pac_n200": 7}.get(name, 5)


def to_float64(model):
    """A learner's state (a tensor or a dict of them), data, masks, decays
    and hyper-prior in float64, in place."""
    import torch

    for attr in ("params", "particles", "posterior", "_mu", "_nu", "train_x", "train_t", "X",
                 "Y", "mask", "_train_mask", "_decay"):
        value = getattr(model, attr, None)
        if isinstance(value, torch.Tensor):
            setattr(model, attr, value.double())
        elif isinstance(value, dict):
            setattr(model, attr, {k: v.double() for k, v in value.items()})
    if hasattr(model, "hyper_prior"):
        model.hyper_prior.loc = model.hyper_prior.loc.double()
        model.hyper_prior.scale = model.hyper_prior.scale.double()


def single_fit(model, n_iter, log_period, valid=None):
    """``fit`` (``meta_fit``) timed on the host clock, ending in a
    synchronise; returns (seconds, last loss)."""
    import torch

    fit = getattr(model, "fit", None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if fit is None:
        loss = model.meta_fit(n_iter=n_iter, log_period=log_period, verbose=False)
    else:
        valid_x, valid_t = valid if valid is not None else (None, None)
        loss = fit(valid_x=valid_x, valid_t=valid_t, n_iter=n_iter, log_period=log_period,
                   verbose=False)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, loss


def single_eval(model, task, test):
    """(seconds, (LL, RMSE, calib)) of the path's eval: ``eval`` on the
    task's test points, or the meta-learner's ``eval_datasets``."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = model.eval(task[2], task[3]) if test is None else model.eval_datasets(test)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, metrics


def jax_initial_single_state(model, record):
    """The JAX learner's initial parameters of a tools/single_task_ref.json
    record, with fresh Adam moments, for ``model.load_state_dict``."""
    import numpy as np

    flat = unpack_ref(record["init_params"], model.layout)
    zeros = np.zeros_like(flat)
    return {"params": flat, "opt_state": {"mu": zeros, "nu": zeros, "count": 0, "lr": 1e-3},
            "step": 0}


def unpack_ref(text, layout):
    """A flat vector of tools/single_task_ref.json (the base64 of its float32
    bytes, less q_chol's upper triangle, which is 0)."""
    import base64

    import numpy as np

    from tools.single_task_ref import stored

    keep = stored(layout)
    full = np.zeros(keep.size, np.float32)
    full[keep] = np.frombuffer(base64.b64decode(text), "<f4")
    return full


def single_twins(name, build_path, seed=30, check=True):
    """TWIN_STEPS steps from the learner's initial state at ``seed`` with the
    kernels, with them disabled (the plain versions on the card, float32)
    and, for GPR-PAC, the plain versions in float64; raises (with
    ``check``) where the gaps pass their limits. Returns the gaps."""
    import numpy as np
    import torch

    from meta_learning_pacoh_torch.ops import cuda
    from tools.single_task_ref import run, skipped

    state = build_path(name, seed=seed).state_dict()
    runs = {}
    for label, disabled, wide in (("kernels", False, False), ("plain", True, False),
                                  ("plain64", True, True)):
        if wide and name != "gpr_pac_n200":
            continue
        if disabled:
            os.environ["PACOH_TORCH_DISABLE_KERNELS"] = "1"
        try:
            model = build_path(name)
            model.load_state_dict(state)
            if wide:
                to_float64(model)
            cuda.reset_launch_counts()
            losses = run(model, TWIN_STEPS, TWIN_STEPS)
            launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
        finally:
            os.environ.pop("PACOH_TORCH_DISABLE_KERNELS", None)
        if disabled and launches:
            raise AssertionError(f"{name}: kernels launched with PACOH_TORCH_DISABLE_KERNELS=1: "
                                 f"{launches}")
        runs[label] = (model.params.detach().cpu().double().numpy(), losses[-1])
    skip = skipped(model.layout)

    def gap(a, b):
        d = np.abs(runs[a][0] - runs[b][0])[~skip]
        return float(d.max()), float(d.mean()), abs(runs[a][1] - runs[b][1]) / abs(runs[b][1])

    out = {"plain": gap("kernels", "plain")}
    print(f"    twin, {TWIN_STEPS} steps from one state: kernels - plain (float32): |param diff| "
          f"max {out['plain'][0]:.3e}, mean {out['plain'][1]:.3e}; loss rel diff "
          f"{out['plain'][2]:.3e} (kernel_nn.b_out excluded)")
    if name == "gpr_pac_n200":
        out["plain64"], out["plain_vs_64"] = gap("kernels", "plain64"), gap("plain", "plain64")
        print(f"    kernels - plain float64: max {out['plain64'][0]:.3e}, mean "
              f"{out['plain64'][1]:.3e}, loss {out['plain64'][2]:.3e}; plain float32 - float64: "
              f"{out['plain_vs_64'][0]:.3e}, {out['plain_vs_64'][1]:.3e}, "
              f"{out['plain_vs_64'][2]:.3e} (limits {PAC_TWIN_F64})")
        if check and not all(g <= lim for g, lim in zip(out["plain64"], PAC_TWIN_F64)):
            raise AssertionError(f"{name}: the kernel path is further from the float64 run "
                                 f"than PAC_TWIN_F64")
    elif check and not (out["plain"][0] <= TWIN_ATOL and out["plain"][1] <= TWIN_MEAN_ATOL
                        and out["plain"][2] <= B6_LOSS_RTOL):
        raise AssertionError(f"{name}: the kernel path and its plain twin disagree")
    return out


def single_jax_parity(name, build_path, ref):
    """The port's steps on the card from the JAX learner's initial state
    against the JAX run of tools/single_task_ref.json, within its tolerance."""
    import numpy as np

    from tools.single_task_ref import run, skipped, stored

    cfg = ref["config"]
    model = build_path(name)
    model.load_state_dict(jax_initial_single_state(model, ref[name]))
    losses = run(model, cfg["steps"], cfg["log_every"])
    rec, tol = ref[name], ref[name]["tolerance"]
    loss_gap = max(abs(g - w) / abs(w) for g, w in zip(losses, rec["losses"]))
    final = unpack_ref(rec["final_params"], model.layout)
    keep = stored(model.layout) & ~skipped(model.layout)
    d = np.abs(model.params.detach().cpu().numpy() - final)[keep]
    print(f"    from the JAX initial parameters, {cfg['steps']} steps: losses "
          f"{[round(v, 6) for v in losses]}; max rel gap to the JAX run {loss_gap:.3e} "
          f"(tolerance {tol['loss_rtol']:.3e}); final |param diff| max {d.max():.3e} "
          f"({tol['param_atol']:.3e}), mean {d.mean():.3e} ({tol['param_mean_atol']:.3e})")
    if not (loss_gap <= tol["loss_rtol"] and d.max() <= tol["param_atol"]
            and d.mean() <= tol["param_mean_atol"]):
        raise AssertionError(f"{name}: the port's fit disagrees with the JAX learner's")
    return {"jax_loss_gap": loss_gap, "jax_param_max": float(d.max()),
            "jax_param_mean": float(d.mean())}


def single_path(name, build_path, task, test, ref, profile_dir):
    """One phase-10 path: the seed-30 fit on the card with its launches,
    eval cold and warm with its launches, the steady rate,
    confidence_intervals, the twins and the JAX parity."""
    import numpy as np
    import torch

    from meta_learning_pacoh_torch.ops import cuda

    model = build_path(name)  # no device: the card by default
    meta = test is not None
    if model.device.type != "cuda" or (meta and model._fused_path_ok()):
        raise AssertionError(f"{name}: on {model.device}, or on a fused path")
    steps = single_steps(name)
    log_period = steps if meta else SINGLE_LOG
    n_evals = 0 if meta else steps // log_period
    cuda.reset_launch_counts()
    fit_s, loss = single_fit(model, steps, log_period, None if meta else task[2:])
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    want = single_expected(name, n_evals)
    print(f"  {name}: P={model.params.numel()}, {steps} steps in {fit_s:.3f} s "
          f"({steps / fit_s:.1f} steps/s, first call, {n_evals} validation evals); last loss "
          f"{loss:.6f}; launches {launches}")
    if launches != want:
        raise AssertionError(f"{name}: the fit's launches {launches}, expected {want}")
    cuda.reset_launch_counts()
    eval_s, (ll, rmse, calib) = single_eval(model, task, test)
    eval_launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    eval_warm_s, _ = single_eval(model, task, test)
    print(f"    eval: {eval_s:.4f} s cold, {eval_warm_s:.4f} s warm; LL {ll:.6f}, RMSE "
          f"{rmse:.6f}, calib {calib:.6f}; launches {eval_launches}")
    if eval_launches != {"chol": single_eval_launches(name)}:
        raise AssertionError(f"{name}: the eval's launches {eval_launches}")
    if not all(math.isfinite(v) for v in (ll, rmse, calib, loss)) or not bool(
            torch.isfinite(model.params).all()):
        raise AssertionError(f"{name}: non-finite parameters, loss or metrics")
    steady_n = SINGLE_LOG
    steady_s, _ = single_fit(model, steady_n, steady_n)
    print(f"    steady state: {steady_n} steps in {steady_s:.4f} s, "
          f"{steady_n / steady_s:.1f} steps/s")
    summary = dict(steps=steps, fit_s=fit_s, fit_steps_per_s=steps / fit_s,
                   steady_steps_per_s=steady_n / steady_s, eval_s=eval_s,
                   eval_warm_s=eval_warm_s, ll=ll, rmse=rmse, calib=calib, launches=launches,
                   eval_launches=eval_launches)
    for k, v in eval_launches.items():
        launches[k] = launches.get(k, 0) + v
    if not meta:
        x_plot = np.linspace(float(task[0].min()), float(task[0].max()), 150)
        if task[0].shape[1] > 1:
            x_plot = np.stack([x_plot] * task[0].shape[1], axis=1)
        ucb, lcb = model.confidence_intervals(x_plot, confidence=0.9)
        print(f"    confidence_intervals at 150 points: ucb - lcb in "
              f"[{float(np.min(ucb - lcb)):.4f}, {float(np.max(ucb - lcb)):.4f}]")
        if not (ucb.shape == lcb.shape == (150,) and np.all(np.isfinite(ucb))
                and np.all(np.isfinite(lcb)) and np.all(ucb > lcb)):
            raise AssertionError(f"{name}: confidence intervals not finite with ucb > lcb")
    if profile_dir:
        summary["trace_20_steps"] = profile(
            f"single_{name}", lambda: single_fit(model, 20, 20), profile_dir)
        print(f"    trace: " + json.dumps(summary["trace_20_steps"]))
    summary["twins"] = single_twins(name, build_path)
    summary.update(single_jax_parity(name, build_path, ref))
    return launches, summary


def single_band(name, build_path, task):
    """Seeds 30-32 fitted as the path's seed-30 fit: the mean test LL and
    RMSE within the band of tools/single_task_band.json."""
    with open(SINGLE_BAND_FILE) as f:
        band = json.load(f)[name]
    lls, rmses = [], []
    for seed in SINGLE_SEEDS:
        model = build_path(name, seed=seed)
        model.fit(valid_x=task[2], valid_t=task[3], n_iter=SINGLE_STEPS, log_period=SINGLE_LOG,
                  verbose=False)
        ll, rmse, _ = model.eval(task[2], task[3])
        lls.append(ll)
        rmses.append(rmse)
    mean_ll, mean_rmse = statistics.mean(lls), statistics.mean(rmses)
    ll_band, rmse_band = band["ll_band"], band["rmse_band"]
    print(f"    seeds {SINGLE_SEEDS}: LL {[round(v, 4) for v in lls]}, RMSE "
          f"{[round(v, 4) for v in rmses]}; mean LL {mean_ll:.4f} (band {ll_band[0]:.4f} +- "
          f"{ll_band[1]:.4f}), mean RMSE {mean_rmse:.4f} (band {rmse_band[0]:.4f} +- "
          f"{rmse_band[1]:.4f})")
    if not (abs(mean_ll - ll_band[0]) <= ll_band[1]
            and abs(mean_rmse - rmse_band[0]) <= rmse_band[1]):
        raise AssertionError(f"{name}: accuracy outside the JAX package's band")
    return {"seed_ll": lls, "seed_rmse": rmses, "mean_ll": mean_ll, "mean_rmse": mean_rmse}


def phase10(profile_dir):
    """The single-task learners and the custom modules through their public
    entry points (tools/single_task_ref.py's paths, learners built without a
    device): each fit with its launches, eval, the steady rate, the twins,
    the JAX parity; the bands of seeds 30-32. Returns the launch counts of
    the paths' seed-30 fits and evals, summed, and a summary a path."""
    import meta_learning_pacoh_torch as pkg
    from tools.single_task_ref import build, path_data

    _, task, cauchy_task = path_data()
    _, test = bign_data()
    with open(SINGLE_REF_FILE) as f:
        ref = json.load(f)

    def build_path(name, seed=30):
        return build(pkg, name, seed=seed)

    launches, summaries = {}, {}
    for name in SINGLE_PATHS:
        path_task = cauchy_task if name == "gpr_mll_n20" else task
        path_test = test if name == "custom_map_t5_n200" else None
        got, summaries[name] = single_path(name, build_path, path_task, path_test, ref,
                                           profile_dir)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        if name in SINGLE_BAND_PATHS:
            summaries[name].update(single_band(name, build_path, task))
    return launches, summaries


def synthetic_idx_images(path, n, seed=0):
    """n smooth 28 x 28 uint8 images (random intensity ramps) in a gzipped IDX3 file."""
    import gzip
    import struct

    import numpy as np

    rs = np.random.RandomState(seed)
    grid = np.linspace(0.0, 1.0, 28)
    a, b, c = rs.uniform(-1.0, 1.0, (3, n, 1, 1))
    img = a * grid[None, :, None] + b * grid[None, None, :] + c * grid[None, :, None] ** 2
    img = (img - img.min(axis=(1, 2), keepdims=True)) / np.ptp(img, axis=(1, 2), keepdims=True)
    img = np.round(255 * img).astype(np.uint8)
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, *img.shape) + img.tobytes())


def on_card(model):
    """Whether a learner built with no device put its parameters on the card."""
    return model.device.type == "cuda" and model.params.is_cuda


def maml_np_metrics(learner, model, test):
    """{'rmse'} (MAML) or {'ll', 'rmse', 'calib'} (the NP) of eval_datasets."""
    metrics = model.eval_datasets(test)
    return {"rmse": metrics} if learner == "maml" else dict(zip(("ll", "rmse", "calib"),
                                                                 metrics))


def maml_np_band(learner, band, seed30, build_seed, test):
    """Seeds 30-32 at MAML_NP_BAND_STEPS steps (seed 30's metrics from its full
    fit): the mean of each banded metric within tools/maml_np_band.json's band
    at that length."""
    import statistics

    per_seed = [seed30]
    for seed in MAML_NP_SEEDS[1:]:
        model = build_seed(seed)
        model.meta_fit(n_iter=MAML_NP_BAND_STEPS, log_period=MAML_NP_BAND_STEPS, verbose=False)
        per_seed.append(maml_np_metrics(learner, model, test))
    out = {}
    for metric, rec in band[learner][str(MAML_NP_BAND_STEPS)].items():
        values = [m[metric] for m in per_seed]
        mean = statistics.mean(values)
        centre, margin = rec["band"]
        print(f"    seeds {MAML_NP_SEEDS} at {MAML_NP_BAND_STEPS} steps: {metric} "
              f"{[round(v, 4) for v in values]}, mean {mean:.4f} (band {centre:.4f} +- "
              f"{margin:.4f})")
        if abs(mean - centre) > margin:
            raise AssertionError(f"{learner}: seeds {MAML_NP_SEEDS}' {metric} outside the JAX "
                                 f"package's band")
        out[f"seed_{metric}"], out[f"mean_{metric}"] = values, mean
    return out


def maml_np_parity(learner, ref):
    """The port's steps on the card from the JAX learner's initial state with
    its draws against the JAX run of tools/maml_np_ref.json (the NP in float64
    on both sides), within its tolerance; then the same steps in float32 on the
    card and on the CPU (the twin), within the twins' limits."""
    import numpy as np

    import meta_learning_pacoh_torch as pkg
    from tools.maml_np_ref import build, gaps, run, start

    cfg, rec = ref["config"], ref[learner]
    tol = rec["tolerance"]
    model = build(pkg, learner)
    start(model, learner, rec)
    losses = run(model, cfg["steps"], cfg["log_every"])
    loss_gap, gap_max, gap_mean = gaps(model, rec, losses)
    precision = "float64" if rec["float64"] else "float32"
    print(f"    from the JAX initial parameters with its draws, {cfg['steps']} steps in "
          f"{precision}: losses {[round(v, 6) for v in losses]}; max rel gap to the JAX run "
          f"{loss_gap:.3e} (tolerance {tol['loss_rtol']:.3e}); final |param diff| max "
          f"{gap_max:.3e} ({tol['param_atol']:.3e}), mean {gap_mean:.3e} "
          f"({tol['param_mean_atol']:.3e})")
    if not (loss_gap <= tol["loss_rtol"] and gap_max <= tol["param_atol"]
            and gap_mean <= tol["param_mean_atol"]):
        raise AssertionError(f"{learner}: the port's fit disagrees with the JAX learner's")
    twins = {}
    for device in ("card", "cpu"):
        twin = build(pkg, learner, **({} if device == "card" else {"device": "cpu"}))
        start(twin, learner, rec, wide=False)
        twins[device] = (run(twin, cfg["steps"], cfg["steps"])[-1],
                         twin.params.detach().cpu().numpy())
    d = np.abs(twins["card"][1] - twins["cpu"][1])
    twin_loss = abs(twins["card"][0] - twins["cpu"][0]) / abs(twins["cpu"][0])
    print(f"    twin, the same {cfg['steps']} steps in float32 on the card and on the CPU: "
          f"|param diff| max {d.max():.3e}, mean {d.mean():.3e}; loss rel diff "
          f"{twin_loss:.3e}")
    if not (d.max() <= TWIN_ATOL and d.mean() <= TWIN_MEAN_ATOL and twin_loss <= B6_LOSS_RTOL):
        raise AssertionError(f"{learner}: the card's steps and the CPU's disagree")
    return {"jax_loss_gap": loss_gap, "jax_param_max": gap_max, "jax_param_mean": gap_mean,
            "jax_precision": precision, "twin_param_max": float(d.max()),
            "twin_param_mean": float(d.mean()), "twin_loss_rel": twin_loss}


def maml_np_path(learner, ref, band, profile_dir):
    """One learner's sin_20 path: built with no device, the full fit (its
    metrics read at MAML_NP_BAND_STEPS on the way), eval cold and warm, the
    steady rate, the trace, the JAX parity and the twin, the band."""
    import torch

    import meta_learning_pacoh_torch as pkg
    from tools.maml_np_ref import build, sin20

    _, test = sin20()
    model = build(pkg, learner)  # no device: the card by default
    if not (on_card(model) and model.X.device.type == model.device.type):
        raise AssertionError(f"{learner}: built with no device, not on the card")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"{learner}: TF32 products are on")
    fit_s, loss = single_fit(model, MAML_NP_BAND_STEPS, MAML_NP_BAND_STEPS)
    seed30 = maml_np_metrics(learner, model, test)
    rest_s, loss = single_fit(model, MAML_NP_STEPS - MAML_NP_BAND_STEPS,
                              MAML_NP_STEPS - MAML_NP_BAND_STEPS)
    fit_s += rest_s
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = maml_np_metrics(learner, model, test)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    maml_np_metrics(learner, model, test)
    torch.cuda.synchronize()
    eval_warm_s = time.perf_counter() - t0
    steady_s, _ = single_fit(model, MAML_NP_STEADY, MAML_NP_STEADY)
    print(f"  {learner}: P={model.params.numel()}, {MAML_NP_STEPS} steps in {fit_s:.3f} s "
          f"({MAML_NP_STEPS / fit_s:.1f} steps/s, first call); last loss {loss:.6f}; steady "
          f"{MAML_NP_STEADY / steady_s:.1f} steps/s; eval on {len(test)} tasks {eval_s:.4f} s "
          f"cold, {eval_warm_s:.4f} s warm: {json.dumps(metrics)}")
    if not (math.isfinite(loss) and all(math.isfinite(v) for v in metrics.values())
            and bool(torch.isfinite(model.params).all())):
        raise AssertionError(f"{learner}: non-finite parameters, loss or metrics")
    summary = dict(steps=MAML_NP_STEPS, fit_s=fit_s, fit_steps_per_s=MAML_NP_STEPS / fit_s,
                   steady_steps_per_s=MAML_NP_STEADY / steady_s, eval_s=eval_s,
                   eval_warm_s=eval_warm_s, **metrics)
    if learner == "np":
        ucb, lcb = model.confidence_intervals(*test[0][:2], test[0][2], confidence=0.9)
        print(f"    confidence_intervals at {len(ucb)} points: ucb - lcb in "
              f"[{float((ucb - lcb).min()):.4f}, {float((ucb - lcb).max()):.4f}]")
        if not (ucb.shape == lcb.shape and (ucb > lcb).all()):
            raise AssertionError("np: confidence intervals not ordered")
    if profile_dir:
        summary["trace_100_steps"] = profile(
            f"{learner}_sin_20", lambda: single_fit(model, MAML_NP_TRACE, MAML_NP_TRACE),
            profile_dir)
        print("    trace: " + json.dumps(summary["trace_100_steps"]))
    summary.update(maml_np_parity(learner, ref))
    summary.update(maml_np_band(learner, band, seed30,
                                lambda seed: build(pkg, learner, seed=seed), test))
    return summary


def np_img_path():
    """The image NP through mnist_image_batches and its trainer, built with no
    device, on synthetic images: the epoch losses finite, the loss of one held
    batch on fixed masks and latents lower after training, and inpaint's
    [1, 28, 28] mean and positive sigma."""
    import tempfile

    import numpy as np
    import torch

    from meta_learning_pacoh_torch.datasets.np_image_data import mnist_image_batches
    from meta_learning_pacoh_torch.models.neural_process_img import (
        NeuralProcessImg,
        NeuralProcessImgTrainer,
        batch_context_target_mask,
    )

    with tempfile.TemporaryDirectory() as tmp:
        synthetic_idx_images(os.path.join(tmp, "train-images-idx3-ubyte.gz"), NP_IMG_IMAGES)
        batches = mnist_image_batches(batch_size=NP_IMG_BATCH, size=28, path_to_data=tmp,
                                      random_state=np.random.RandomState(0))
    model = NeuralProcessImg((1, 28, 28), random_seed=0)
    if not on_card(model):
        raise AssertionError("np_img: built with no device, not on the card")
    held = batches.images[:NP_IMG_BATCH]
    cm, tm = batch_context_target_mask((1, 28, 28), 50, 100, NP_IMG_BATCH,
                                       random_state=np.random.RandomState(1))
    noise = model._generator.get_state()

    def held_loss():
        model._generator.set_state(noise)
        return model.forward_loss(held, cm, tm)

    before = held_loss()
    trainer = NeuralProcessImgTrainer(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = trainer.train(batches, epochs=NP_IMG_EPOCHS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    after = held_loss()
    mean, sigma = model.inpaint(held[0], cm[0])
    print(f"  np_img: P={model.params.numel()}, {trainer.steps} steps ({NP_IMG_EPOCHS} epochs of "
          f"{len(batches)} batches of {NP_IMG_BATCH}) in {train_s:.3f} s; epoch losses "
          f"{[round(v, 3) for v in history]}; held batch {before:.3f} -> {after:.3f}; inpaint "
          f"{mean.shape}, sigma in [{sigma.min():.4f}, {sigma.max():.4f}]")
    if not (all(math.isfinite(v) for v in history) and math.isfinite(after) and after < before):
        raise AssertionError("np_img: the loss is not finite or does not fall")
    if not (mean.shape == sigma.shape == (1, 28, 28) and np.isfinite(mean).all()
            and (sigma > 0).all()):
        raise AssertionError("np_img: inpaint's mean or sigma is malformed")
    return {"steps": trainer.steps, "train_s": train_s, "epoch_losses": history,
            "held_loss_before": before, "held_loss_after": after}


def phase11(profile_dir):
    """MAML and the Neural Process on sin_20 and the image NP, from learners
    built with no device; no kernel may launch. Returns a summary a slice."""
    from meta_learning_pacoh_torch.ops import cuda

    with open(MAML_NP_REF_FILE) as f:
        ref = json.load(f)
    with open(MAML_NP_BAND_FILE) as f:
        band = json.load(f)
    cuda.reset_launch_counts()
    summaries = {f"{learner}_sin_20": maml_np_path(learner, ref, band, profile_dir)
                 for learner in ("maml", "np")}
    summaries["np_img"] = np_img_path()
    launched = {k: v for k, v in cuda.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"phase 11 launched kernels: {launched}")
    return summaries


def phase2_b1(errs, walls):
    """The single-task paths' shapes, one system a launch: the B4 forward
    and backward and K4 at N=200 (GPR-MLL's and GPR-PAC's), K2 and K3 at
    N=20 (the cauchy_20 task's), each against its plain version, a system
    that fails at every jitter level NaN through each, and each timed as
    device time (``device_pair``) beside its library call: the factor alone
    (``cholesky_ex``) for the forwards and K4, K^-1 from L
    (``cholesky_inverse``) for the backwards, into ONE_SYSTEM."""
    import torch

    from meta_learning_pacoh_torch.ops.cuda import blocked_mll_kernel as bk
    from meta_learning_pacoh_torch.ops.cuda import chol_kernel, mll_kernel

    gen = torch.Generator().manual_seed(10)
    out = {}
    for n, fwd, fwd_ref, bwd, bwd_ref, label in (
            (200, bk.blocked_mll_fwd, bk.blocked_mll_fwd_ref, bk.blocked_mll_bwd,
             bk.blocked_mll_bwd_ref, "blocked"),
            (20, mll_kernel.mll_fwd, mll_kernel.mll_fwd_ref, mll_kernel.mll_bwd,
             mll_kernel.mll_bwd_ref, "mll")):
        kn = spd(1, n, gen, scale=0.5)
        r = torch.randn(1, n, generator=gen).cuda()
        gq, gl = torch.randn(1, generator=gen).cuda(), torch.randn(1, generator=gen).cuda()
        print(f"  {label}_fwd/bwd at B=1, N={n}:")
        got, want = fwd(kn, r), fwd_ref(kn, r)
        for part, g_, w_ in zip(("quad", "logdet", "L", "z"), got, want):
            check(f"{label}_fwd", g_.reshape(1, -1), w_.reshape(1, -1), errs)
            print(f"    ({part})")
        _, _, L, z = want
        for part, g_, w_ in zip(("dkn", "dr"), bwd(L, z, gq, gl), bwd_ref(L, z, gq, gl)):
            check(f"{label}_bwd", g_.reshape(1, -1), w_.reshape(1, -1), errs)
            print(f"    ({part})")
        failed = kn - 10.0 * torch.eye(n, device="cuda")
        _, _, fL, fz = fwd(failed, r)
        dkn, dr = bwd(fL, fz, gq, gl)
        if not (bool((~torch.isfinite(fz)).all()) and bool((~torch.isfinite(dkn)).all())
                and bool((~torch.isfinite(dr)).all())
                and not bool(torch.isfinite(fwd_ref(failed, r)[3]).any())):
            raise AssertionError(f"{label} at B=1, N={n}: a failed system is not non-finite "
                                 f"through both directions")
        print("    a system failing at every level: non-finite through the forward and the "
              "backward, as in the plain version")
        f_ms = device_pair(f"{label}_fwd at B=1", lambda: fwd(kn, r), lambda: fwd_ref(kn, r),
                           walls)
        b_ms = device_pair(f"{label}_bwd at B=1", lambda: bwd(L, z, gq, gl),
                           lambda: bwd_ref(L, z, gq, gl), walls)
        lib_f = library_time(f"{label}_fwd at B=1", lambda: torch.linalg.cholesky_ex(kn))
        lib_b = library_time(f"{label}_bwd at B=1", lambda: torch.cholesky_inverse(L))
        tri = n * (n + 1) // 2
        # the forward: one factorization, the solve, quad and logdet; in the
        # lower triangle of Kn and r, out L, z, quad, logdet. The backward:
        # L^-1 and the symmetric W^T W; in the triangle of L, z, gq, gl; out dKn, dr
        out[f"{label}_fwd"] = bound_record(f_ms, lib_f, n ** 3 / 3 + n * n + 3 * n,
                                           4 * (tri + n + n * n + n + 2))
        out[f"{label}_bwd"] = bound_record(b_ms, lib_b, 2 * n ** 3 / 3 + 3 * n * n,
                                           4 * (tri + n + 2 + n * n + n))
    a = spd(1, 200, gen)
    check("chol", chol_kernel.cholesky_fused(a), chol_kernel.cholesky_ref(a), errs)
    failed = a - 10.0 * torch.eye(200, device="cuda")
    if not bool(torch.isnan(chol_kernel.cholesky_fused(failed)).all()):
        raise AssertionError("chol at B=1: an indefinite matrix is not all NaN")
    print("  chol at B=1, N=200: an indefinite matrix all NaN")
    c_ms = device_pair("chol at B=1", lambda: chol_kernel.cholesky_fused(a),
                       lambda: chol_kernel.cholesky_ref(a), walls)
    lib_c = library_time("chol at B=1", lambda: torch.linalg.cholesky_ex(a))
    out["chol"] = bound_record(c_ms, lib_c, 200 ** 3 / 3, 4 * (200 * 201 // 2 + 200 * 200))
    ONE_SYSTEM.update(out)


def twin_state(model):
    """The trained state of a GP learner as one flat CPU vector (SVGD's
    particles, VI's posterior, MAP's parameters), the kernel net's output
    bias left out: its MLL gradient is exactly 0 (pairwise feature distances
    are shift-invariant), so Adam random-walks float noise there."""
    import torch

    from meta_learning_pacoh_torch.models.random_gp import layout_slice

    if hasattr(model, "particles"):
        skip, leaves = model.hyper_prior.slice_of(("kernel_nn", "b_out")), [model.particles]
    elif hasattr(model, "posterior"):
        skip = model.hyper_prior.slice_of(("kernel_nn", "b_out"))
        leaves = [model.posterior[k] for k in sorted(model.posterior)]
    else:
        skip, leaves = layout_slice(model.layout, ("kernel_nn", "b_out")), [model.params]
    keep = torch.ones(leaves[0].shape[-1], dtype=torch.bool)
    keep[skip] = False
    return torch.cat([leaf.detach().cpu()[..., keep].reshape(-1) for leaf in leaves])


def general_twins(build, n_iter):
    """Each of ``build``'s learners fitted alone by its general step
    (``PACOH_TORCH_DISABLE_FUSED=1``) for ``n_iter`` steps."""
    os.environ["PACOH_TORCH_DISABLE_FUSED"] = "1"
    try:
        models = build()
        for m in models:
            m.meta_fit(n_iter=n_iter, log_period=n_iter, verbose=False)
        return models
    finally:
        os.environ.pop("PACOH_TORCH_DISABLE_FUSED")


def twin_gaps(label, got, want, limits=None):
    """The largest (max, mean) |diff| of ``twin_state`` between each fit of
    ``got`` and its other run in ``want``; with ``limits`` (max, mean), raise
    beyond them."""
    worst = (0.0, 0.0)
    for a, b in zip(got, want):
        d = (twin_state(a).double() - twin_state(b).double()).abs()
        worst = (max(worst[0], float(d.max())), max(worst[1], float(d.mean())))
    held = "" if limits is None else f" (limits {limits[0]:.3e}, {limits[1]:.3e})"
    print(f"  {label}: |diff| max {worst[0]:.3e}, mean {worst[1]:.3e} over {len(got)} fits"
          f"{held}; kernel_nn.b_out left out")
    if limits is not None and not (worst[0] <= limits[0] and worst[1] <= limits[1]):
        raise AssertionError(f"{label}: beyond the limits")
    return worst


def launched():
    from meta_learning_pacoh_torch.ops import cuda

    return {k: v for k, v in cuda.LAUNCHES.items() if v}


def phase12a(profile_dir):
    """The meta-overfitting sweep's seeds as one stacked PACOH-SVGD fit on
    cauchy_20 (each seed its own data), through ``fit_models_parallel``."""
    import numpy as np
    import torch

    from meta_learning_pacoh_torch import GPRegressionMetaLearnedSVGD
    from meta_learning_pacoh_torch.datasets import provide_data
    from meta_learning_pacoh_torch.ops import cuda
    from meta_learning_pacoh_torch.parallel import fit_models_parallel

    data = {seed: provide_data("cauchy_20", seed=seed) for seed in SWEEP_SEEDS}

    def build(seeds=SWEEP_SEEDS):
        return [GPRegressionMetaLearnedSVGD(data[seed][0], num_particles=10, random_seed=seed,
                                            task_batch_size=-1) for seed in seeds]

    models = build()
    m0 = models[0]
    (t, n, d), k, p = m0.X.shape, m0.num_particles, m0.hyper_prior.dim
    if [len(models), k, p] != list(K1_SEED_ROWS["svgd_phi seeds [5, 10, 2372]"]):
        raise AssertionError(f"12a: K1 at {[len(models), k, p]}")
    print(f"  12a seed_cauchy_20: seeds {SWEEP_SEEDS}, each {t} tasks x {n} points (D={d}) of "
          f"its own provide_data('cauchy_20', seed), K={k}, P={p}; {len(models) * k * t} "
          f"systems of N={n} a step")
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    fit_models_parallel(models, n_iter=SWEEP_STEPS, prefer="vmap")
    torch.cuda.synchronize()
    stacked_s = time.perf_counter() - t0
    fit_launches = launched()
    want = {"svgd_phi": SWEEP_STEPS, "mll_fwd": SWEEP_STEPS, "mll_bwd": SWEEP_STEPS}
    print(f"  stacked fit: {SWEEP_STEPS} steps of {len(models)} fits in {stacked_s:.3f} s "
          f"({SWEEP_STEPS / stacked_s:.1f} steps/s, first call); launches {fit_launches}")
    if fit_launches != want:
        raise AssertionError(f"12a: launches {fit_launches}, want {want}: K1 one launch of "
                             f"[{len(models)}, {k}, {p}] a step, K2 and K3 one of "
                             f"{len(models) * k * t} systems a step")
    seq_t0 = time.perf_counter()
    seq = general_twins(build, SWEEP_STEPS)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - seq_t0
    print(f"  the {len(seq)} sequential general-step fits: {SWEEP_STEPS} steps each in "
          f"{seq_s:.3f} s ({len(seq) * SWEEP_STEPS / seq_s:.1f} steps/s)")
    skip = m0.hyper_prior.slice_of(("kernel_nn", "b_out"))
    gaps_500 = [diff_excluding(a.particles.cpu(), b.particles.cpu(), skip)
                for a, b in zip(models, seq)]
    print(f"  after {SWEEP_STEPS} steps, stacked - sequential |particle diff| (max, mean) a "
          f"seed: {[(f'{a:.3e}', f'{b:.3e}') for a, b in gaps_500]}")
    metrics = {}
    for seed, a, b in zip(SWEEP_SEEDS, models, seq):
        test = data[seed][2][:EVAL_TWIN_TASKS]
        cuda.reset_launch_counts()
        got = np.asarray(a.eval_datasets(test))
        if not launched().get("chol"):
            raise AssertionError("12a: the eval ran no K4")
        ref = np.asarray(b.eval_datasets(test))
        metrics[seed] = got.tolist()
        print(f"  seed {seed} eval ({EVAL_TWIN_TASKS} test tasks) stacked {got.tolist()}, "
              f"sequential {ref.tolist()}")
        if not (np.all(np.isfinite(got)) and np.allclose(got, ref, rtol=EVAL_TWIN_TOL,
                                                         atol=EVAL_TWIN_TOL)):
            raise AssertionError(f"12a: seed {seed}'s stacked metrics disagree with its own fit")

    # twins: TWIN_STEPS from the states after the fit, stacked against each
    # seed alone and against the stack with the kernels off
    later = [m.state_dict() for m in models]

    def from_later():
        group = build()
        for m, state in zip(group, later):
            m.load_state_dict(state)
        return group

    stacked = from_later()
    fit_models_parallel(stacked, n_iter=TWIN_STEPS, prefer="vmap")
    alone = general_twins(from_later, TWIN_STEPS)
    os.environ["PACOH_TORCH_DISABLE_KERNELS"] = "1"
    try:
        plain, wide = from_later(), from_later()
        for m in wide:
            to_float64(m)
        cuda.reset_launch_counts()
        fit_models_parallel(plain, n_iter=TWIN_STEPS, prefer="vmap")
        fit_models_parallel(wide, n_iter=TWIN_STEPS, prefer="vmap")
        if launched():
            raise AssertionError(f"12a: kernels launched with the kernels off: {launched()}")
    finally:
        os.environ.pop("PACOH_TORCH_DISABLE_KERNELS")
    # stacked and alone part by cuBLAS's float order at other batch sizes
    # (1.6e-4 max measured, beyond the twins' 1e-4; the run alone was the
    # farther from float64): each float32 run is held to the float64 run
    # within twice the JAX float32 step's own drift from its float64 run at
    # cauchy_20's later state (tools/c1_drift.json, as phase 3's later twins)
    twin_seq = twin_gaps(f"twins ({TWIN_STEPS} steps from the fitted states), stacked - each "
                         f"seed's own general step", stacked, alone)
    twin_plain = twin_gaps("twins, stacked - stacked with the kernels off", stacked, plain,
                           (TWIN_ATOL, TWIN_MEAN_ATOL))
    lim = later_limits()
    twin_f64 = {label: twin_gaps(f"twins, {label} - the plain stacked step in float64", runs,
                                 wide, lim)
                for label, runs in (("stacked", stacked), ("each seed alone", alone),
                                    ("stacked with the kernels off", plain))}
    # rates: the stack's steps/s beside one fit's general step
    steady = 100 / timed_stacked(stacked, 100)
    os.environ["PACOH_TORCH_DISABLE_FUSED"] = "1"
    try:
        one_rate = 100 / timed_fit(alone[0], 100, 100)
    finally:
        os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
    print(f"  steady state: stacked {steady:.1f} steps/s ({len(models)} fits a step: "
          f"{len(models) * steady:.1f} fit-steps/s); one fit's general step {one_rate:.1f} "
          f"steps/s; stacked / one {steady / one_rate:.3f}")
    traces = {}
    if profile_dir:
        traces["seed_stack_20_steps"] = profile(
            "seed_stack", lambda: fit_models_parallel(stacked, n_iter=20, prefer="vmap"),
            profile_dir)
        os.environ["PACOH_TORCH_DISABLE_FUSED"] = "1"
        try:
            traces["one_seed_20_steps"] = profile(
                "one_seed", lambda: alone[0].meta_fit(n_iter=20, log_period=20, verbose=False),
                profile_dir)
        finally:
            os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
    for label, summary in traces.items():
        print(f"  trace {label}: " + json.dumps(summary))
    return fit_launches["svgd_phi"], dict(
        seeds=list(SWEEP_SEEDS), shape=[len(models), k, p], stacked_fit_s=stacked_s,
        sequential_fits_s=seq_s, stacked_steps_per_s=steady, one_fit_steps_per_s=one_rate,
        launches=fit_launches, metrics=metrics, gaps_after_fit=gaps_500,
        twin_sequential=twin_seq, twin_plain=twin_plain, twin_f64=twin_f64, traces=traces)


def timed_stacked(models, n_iter):
    """Seconds of ``n_iter`` stacked steps of ``models``."""
    import torch

    from meta_learning_pacoh_torch.parallel import fit_models_parallel

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit_models_parallel(models, n_iter=n_iter, prefer="vmap")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def sweep_map_cell(seed):
    """run_overfitting_sweep.py's PACOH-MAP cell (build_one, :41-66): sin_32's
    first 32 validation tasks' contexts train, their held-out points and 50
    test tasks evaluate."""
    from meta_learning_pacoh_torch import GPRegressionMetaLearned
    from meta_learning_pacoh_torch.datasets import provide_data

    _, valid, test = provide_data("sin_32", seed=seed)
    meta_train = valid[:32]
    train = [(cx, cy) for cx, cy, _, _ in meta_train]
    model = GPRegressionMetaLearned(train, weight_decay=0.1, num_iter_fit=SWEEP_FUSED_STEPS,
                                    random_seed=seed)
    return model, meta_train, test[:SWEEP_TEST_TASKS]


def sweep_eval(model, meta_train, test):
    """eval_one of run_overfitting_sweep.py (:68-80)."""
    ll_tr, rmse_tr, _ = model.eval_datasets(meta_train)
    ll_te, rmse_te, calib = model.eval_datasets(test)
    return {"test_rmse_meta_train": rmse_tr, "test_rmse_meta_test": rmse_te,
            "test_ll_meta_train": ll_tr, "test_ll_meta_test": ll_te, "calib_err": calib}


def phase12b():
    """The sweep's PACOH-MAP cell on sin_32, seeds 22-26, through both routes
    of ``fit_models_parallel``: 'vmap' (the stacked general step) and
    'sequential_fused' (each seed's own B6 fit). Their times decide 'auto'."""
    import torch

    from meta_learning_pacoh_torch.ops import cuda
    from meta_learning_pacoh_torch.parallel import fit_models_parallel, seed_parallel

    cells = {seed: sweep_map_cell(seed) for seed in SWEEP_SEEDS}
    stacked = [cells[seed][0] for seed in SWEEP_SEEDS]
    m0 = stacked[0]
    print(f"  12b seed_map_sin_32: seeds {SWEEP_SEEDS}, {m0.n_tasks} tasks x "
          f"{m0.X.shape[1]} points, task batch {m0.task_batch_size}, weight decay 0.1, "
          f"P={m0.params.numel()}; every seed in B6's window: "
          f"{all(m._fused_path_ok() for m in stacked)}")
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    fit_models_parallel(stacked, n_iter=SWEEP_VMAP_STEPS, prefer="vmap")
    torch.cuda.synchronize()
    vmap_s = time.perf_counter() - t0
    if launched():
        raise AssertionError(f"12b: the stacked MAP step at N=5 launched {launched()}")
    fused = [sweep_map_cell(seed)[0] for seed in SWEEP_SEEDS]
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    fit_models_parallel(fused, n_iter=SWEEP_FUSED_STEPS, prefer="sequential_fused")
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    if set(launched()) != {"fused_map"}:
        raise AssertionError(f"12b: 'sequential_fused' did not run on B6 alone: {launched()}")
    # the time a fit-step on each route, and 'vmap' at the fused fits' length
    vmap_fit_step = vmap_s / (SWEEP_VMAP_STEPS * len(stacked))
    fused_fit_step = fused_s / (SWEEP_FUSED_STEPS * len(fused))
    ratio = vmap_fit_step / fused_fit_step
    print(f"  'vmap': {SWEEP_VMAP_STEPS} stacked steps in {vmap_s:.3f} s "
          f"({1e3 * vmap_fit_step:.5f} ms a fit-step); 'sequential_fused': "
          f"{len(fused)} x {SWEEP_FUSED_STEPS} B6 steps in {fused_s:.3f} s "
          f"({1e3 * fused_fit_step:.5f} ms a fit-step, {launched()['fused_map']} launches); "
          f"'sequential_fused' {ratio:.1f}x faster a fit-step")
    auto = "sequential_fused" if seed_parallel._all_fused(stacked) else "vmap"
    winner = "sequential_fused" if ratio > 1.0 else "vmap"
    print(f"  'auto' takes {auto!r} for this group; the faster route here: {winner!r} "
          f"(the docstring's claim: 'sequential_fused' wherever every model is in a fused "
          f"window)")
    if auto != winner:
        raise AssertionError("12b: 'auto' disagrees with the measured faceoff")
    metrics = {}
    for seed, model in zip(SWEEP_SEEDS, fused):
        _, meta_train, test = cells[seed]
        metrics[seed] = {"sequential_fused": sweep_eval(model, meta_train, test),
                         "vmap_1000": sweep_eval(cells[seed][0], meta_train, test)}
        values = [v for route in metrics[seed].values() for v in route.values()]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"12b: seed {seed}: non-finite metrics {metrics[seed]}")
    for seed, m in metrics.items():
        print(f"  seed {seed}: " + json.dumps(m))
    return dict(seeds=list(SWEEP_SEEDS), vmap_steps=SWEEP_VMAP_STEPS, vmap_s=vmap_s,
                fused_steps=SWEEP_FUSED_STEPS, fused_s=fused_s,
                vmap_ms_per_fit_step=1e3 * vmap_fit_step,
                fused_ms_per_fit_step=1e3 * fused_fit_step, fused_over_vmap=ratio,
                auto=auto, metrics=metrics)


def trial_families(train):
    """phase 12c's trial groups on sin_20: (configs, build) of SVGD, VI, MAP."""
    from meta_learning_pacoh_torch import (
        GPRegressionMetaLearned,
        GPRegressionMetaLearnedSVGD,
        GPRegressionMetaLearnedVI,
    )

    svgd_vi = [{"lr": lr, "prior_factor": pf} for lr in (1e-3, 3e-3) for pf in (0.01, 0.1)]
    return {
        "svgd": (svgd_vi, lambda c: GPRegressionMetaLearnedSVGD(
            train, num_iter_fit=TRIAL_STEPS, num_particles=10, random_seed=30,
            task_batch_size=-1, lr=c["lr"], prior_factor=c["prior_factor"])),
        "vi": (svgd_vi, lambda c: GPRegressionMetaLearnedVI(
            train, num_iter_fit=TRIAL_STEPS, random_seed=30, lr=c["lr"],
            prior_factor=c["prior_factor"])),
        "map": ([{"lr_params": lr, "weight_decay": wd} for lr in (1e-3, 3e-3)
                 for wd in (0.1, 0.2)], lambda c: GPRegressionMetaLearned(
            train, num_iter_fit=TRIAL_STEPS, random_seed=30, lr_params=c["lr_params"],
            weight_decay=c["weight_decay"])),
    }


def phase12c():
    """Hyper-parallel trials on phase 4's sin_20 data: ``run_trial_batch``
    for SVGD, VI and MAP groups of four, each trial held to its own
    general-step fit; then a batched ``tune_run`` with TPE."""
    import tempfile

    import torch

    from meta_learning_pacoh_torch.ops import cuda
    from meta_learning_pacoh_torch.utils.tuning import LogUniform, Uniform, tune_run
    from meta_learning_pacoh_torch.utils.tuning_parallel import (
        fit_hyper_parallel,
        run_trial_batch,
    )

    train, test = sin20()

    def evaluate(model):
        return dict(zip(("test_ll", "test_rmse", "calib_err"), model.eval_datasets(test)))

    summary = {}
    for family, (configs, build) in trial_families(train).items():
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        results = run_trial_batch(configs, build, evaluate, n_iter=TRIAL_STEPS, static_keys=())
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
        counts = launched()
        in_fit = {k: v for k, v in counts.items() if k != "chol_small"}  # the evals' B5
        want = {"svgd_phi": TRIAL_STEPS} if family == "svgd" else {}
        print(f"  12c {family}: {len(configs)} trials x {TRIAL_STEPS} steps stacked, with "
              f"their evals, in {batch_s:.3f} s; launches {counts}")
        if in_fit != want:
            raise AssertionError(f"12c {family}: launches {counts}, want {want} and the "
                                 f"evals' B5")
        if family == "svgd":
            k1, shape = counts["svgd_phi"], [len(configs), 10, build(configs[0]).hyper_prior.dim]
            print(f"  K1 at {shape}: {k1} launches, one a step for the {len(configs)} trials")
            if shape != list(K1_SEED_ROWS["svgd_phi trials [4, 10, 2308]"]):
                raise AssertionError(f"12c: K1 at {shape}")
        for c, r in zip(configs, results):
            print(f"    {c}: {r}")
            if not all(math.isfinite(v) for v in r.values()):
                raise AssertionError(f"12c {family}: non-finite metrics")
        group = [build(c) for c in configs]
        fit_hyper_parallel(group, n_iter=TWIN_STEPS)
        twins = general_twins(lambda: [build(c) for c in configs], TWIN_STEPS)
        gap = twin_gaps(f"{family} trials ({TWIN_STEPS} steps), stacked - each trial alone",
                        group, twins, (TWIN_ATOL, TWIN_MEAN_ATOL))
        summary[family] = dict(trials=configs, results=results, seconds=batch_s,
                               launches=counts, twin=gap)

    # tune_run with TPE, two batches of MAP trials through run_trial_batch
    configs, build = trial_families(train)["map"]
    space = {"lr_params": LogUniform(1e-4, 1e-2), "weight_decay": Uniform(0.0, 0.5)}

    def trial_alone(config):
        raise AssertionError("12c: tune_run fell back to a sequential trial")

    def batch(cfgs):
        return run_trial_batch(cfgs, build, evaluate, n_iter=TUNE_STEPS, static_keys=())

    with tempfile.TemporaryDirectory() as local_dir:
        t0 = time.perf_counter()
        analysis = tune_run(trial_alone, space, num_samples=2 * TUNE_BATCH, metric="test_ll",
                            mode="max", search_alg="tpe", seed=0, local_dir=local_dir,
                            name="trials_sin_20", verbose=False, batch_size=TUNE_BATCH,
                            batch_trial_fn=batch)
        tune_s = time.perf_counter() - t0
    trials = analysis.trials
    durations = [t["duration"] for t in trials]
    rounds = [durations[i:i + TUNE_BATCH] for i in range(0, len(trials), TUNE_BATCH)]
    print(f"  tune_run (TPE, batch_size={TUNE_BATCH}, {TUNE_STEPS} steps a trial): "
          f"{len(trials)} trials in {tune_s:.3f} s, statuses "
          f"{sorted({t['status'] for t in trials})}, s/trial by round "
          f"{[r[0] for r in rounds]}")
    if not (len(trials) == 2 * TUNE_BATCH and all(t["status"] == "DONE" for t in trials)
            and all(len(set(r)) == 1 for r in rounds)):
        raise AssertionError("12c: tune_run did not take its batch path for every trial")
    summary["tune_run"] = dict(seconds=tune_s, rounds=[r[0] for r in rounds],
                               best=max(t["last_result"]["test_ll"] for t in trials))
    return k1, summary


# phase 13: the multi-device layer on a one-rank NCCL mesh of this process
MESH_CHOL_NS = (520, 1000, 1024, 2048, 4096)  # 1000: the identity tail
# launches queued a device time of the distributed Cholesky (about a dozen
# a block of 128): more overflow the CUDA runtime's launch queue behind the
# device-side wait, and the host then waits on the card
MESH_CHOL_LAUNCHES = 600
MESH_CHOL_RTOL, MESH_RESID_TOL = 1e-4, 1e-5  # |L - L_ex| / max|L_ex|; ||LL^T - A|| / ||A||
MESH_MLL_N = 1024
MESH_MLL_RTOL = 1e-4  # value and gradients, of the float64 plain run's largest entry
MESH_MAP_TASKS, MESH_MAP_POINTS, MESH_MAP_STEPS = 5, 1024, 20
MESH_GPR_POINTS, MESH_GPR_STEPS = 2048, 20
MESH_SVGD_STEPS, MESH_STEPS = 50, 20
MESH_MLAP_TASKS, MESH_MLAP_META_TEST = 20, 300


def mesh_fit(model, n_iter):
    """Seconds of ``n_iter`` steps of a meta-learner (or a single-task one)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit = model.fit if hasattr(model, "fit") else model.meta_fit
    fit(n_iter=n_iter, log_period=n_iter, verbose=False)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def mesh_twin(label, model, build_twin, n_iter, summary, limits=(TWIN_ATOL, TWIN_MEAN_ATOL)):
    """``n_iter`` steps of ``model`` (built with mesh=) and of its twin without
    a mesh from the same state; their launches, seconds, the twins' gaps
    (within ``limits``) and whether the bits agree, into summary[label]."""
    import torch

    from meta_learning_pacoh_torch.ops import cuda

    twin = build_twin()
    twin.load_state_dict(model.state_dict())
    cuda.reset_launch_counts()
    mesh_s = mesh_fit(model, n_iter)
    mesh_launches = launched()
    cuda.reset_launch_counts()
    twin_s = mesh_fit(twin, n_iter)
    twin_launches = launched()
    gap = twin_gaps(f"13 {label}: mesh against no mesh", [model], [twin], limits)
    same = bool(torch.equal(twin_state(model), twin_state(twin)))
    print(f"  13 {label}: {n_iter} steps {mesh_s:.3f} s with the mesh (launches "
          f"{mesh_launches}), {twin_s:.3f} s without ({twin_launches}); the bits "
          f"{'agree' if same else 'differ'}")
    summary[label] = {"steps": n_iter, "mesh_s": mesh_s, "no_mesh_s": twin_s,
                      "launches": mesh_launches, "no_mesh_launches": twin_launches,
                      "gap_max": gap[0], "gap_mean": gap[1], "same_bits": same}
    return mesh_launches


def require_launches(label, counts, positive, zero=()):
    """Raise unless every kernel of ``positive`` launched and none of ``zero``."""
    missing = [k for k in positive if not counts.get(k)]
    extra = [k for k in zero if counts.get(k)]
    if missing or extra:
        raise AssertionError(f"13 {label}: not launched {missing}, launched {extra}")


def phase13a(mesh, summary):
    """``distributed_cholesky`` alone against ``cholesky_ex``, its device time
    beside it; ``distributed_gp_mll`` at N=1024 against the single-device
    path, a float64 plain run the yardstick."""
    import torch

    from meta_learning_pacoh_torch.ops import cuda
    from meta_learning_pacoh_torch.parallel import distributed_cholesky, distributed_gp_mll

    gen = torch.Generator().manual_seed(13)
    launches, rows = {}, {}
    for n in MESH_CHOL_NS:
        a = spd(1, n, gen)[0]
        cuda.reset_launch_counts()
        L = distributed_cholesky(a, mesh)
        torch.cuda.synchronize()
        k4 = cuda.LAUNCHES["chol"]
        if k4 != -(-n // 128):
            raise AssertionError(f"13a N={n}: {k4} K4 launches, want {-(-n // 128)}")
        for k, v in launched().items():
            launches[k] = launches.get(k, 0) + v
        ref, info = torch.linalg.cholesky_ex(a)
        err = float((L - ref).abs().max() / ref.abs().max())
        resid = float(torch.linalg.norm(L @ L.T - a) / torch.linalg.norm(a))
        if int(info) or not (err <= MESH_CHOL_RTOL and resid <= MESH_RESID_TOL):
            raise AssertionError(f"13a N={n}: |L - L_ex| {err:.3e}, residual {resid:.3e}")
        # device time: calls queued behind a device-side wait (device_ms), in
        # turns with cholesky_ex; the sum of its kernels' device times beside
        run = max(2, MESH_CHOL_LAUNCHES // (12 * k4))
        ex1, ex_host = device_ms(lambda: torch.linalg.cholesky_ex(a), run)
        d1, d_host = device_ms(lambda: distributed_cholesky(a, mesh), run)
        d2, _ = device_ms(lambda: distributed_cholesky(a, mesh), run)
        ex2, _ = device_ms(lambda: torch.linalg.cholesky_ex(a), run)
        summed = profiled_ms(lambda: distributed_cholesky(a, mesh), calls=3)
        wall = statistics.median(median_ms(lambda: distributed_cholesky(a, mesh), 5))
        rows[n] = {"k4_launches": k4, "rel_err": err, "residual": resid,
                   "ms": 0.5 * (d1 + d2), "cholesky_ex_ms": 0.5 * (ex1 + ex2),
                   "host_included": bool(d_host or ex_host), "kernel_sum_ms": summed,
                   "wall_ms": wall}
        print(f"  13a N={n}: {k4} K4 launches (blocks of 128), |L - L_ex| / max|L_ex| "
              f"{err:.3e}, ||LL^T - A|| / ||A|| {resid:.3e}; device {d1:.4f} / {d2:.4f} ms a "
              f"call, cholesky_ex {ex1:.4f} / {ex2:.4f} ms ({run} queued calls"
              f"{', host time included' if d_host or ex_host else ''}); its kernels' sum "
              f"{'not measured' if summed is None else '%.4f ms' % summed}, single-call wall "
              f"{wall:.4f} ms")
    summary["distributed_cholesky"] = rows

    n = MESH_MLL_N
    a = spd(1, n, gen)[0]
    y, mean = torch.randn(n, generator=gen).cuda(), torch.randn(n, generator=gen).cuda()

    def plain(m, k, yy):
        L = torch.linalg.cholesky(k)
        z = torch.linalg.solve_triangular(L, (yy - m)[:, None], upper=False)[:, 0]
        return -0.5 * (z @ z + 2 * torch.log(torch.diagonal(L)).sum() + n * math.log(2 * math.pi))

    def value_and_grads(fn, dtype):
        args = [t.to(dtype).requires_grad_(True) for t in (mean, a, y)]
        v = fn(*args)
        return [v.detach()] + list(torch.autograd.grad(v, args))

    cuda.reset_launch_counts()
    got = value_and_grads(lambda m, k, yy: distributed_gp_mll(m, k, yy, mesh), torch.float32)
    for k, v in launched().items():
        launches[k] = launches.get(k, 0) + v
    f32, f64 = value_and_grads(plain, torch.float32), value_and_grads(plain, torch.float64)
    gaps = {}
    for name, g, p, w in zip(("value", "d_mean", "d_K", "d_y"), got, f32, f64):
        scale = float(w.abs().max())
        gaps[name] = (float((g.double() - w).abs().max()) / scale,
                      float((p.double() - w).abs().max()) / scale)
        if not gaps[name][0] <= MESH_MLL_RTOL:
            raise AssertionError(f"13a distributed_gp_mll {name}: {gaps[name][0]:.3e} of the "
                                 "float64 run")
    print("  13a distributed_gp_mll N=%d: |dist - f64| / max|f64| %s; the single-device "
          "float32 path's %s" % (n, {k: "%.2e" % v[0] for k, v in gaps.items()},
                                 {k: "%.2e" % v[1] for k, v in gaps.items()}))
    summary["distributed_gp_mll"] = {"n": n, "rel_to_f64": {k: v[0] for k, v in gaps.items()},
                                     "single_device_rel_to_f64": {k: v[1]
                                                                  for k, v in gaps.items()}}
    return launches


def phase13():
    """The multi-device layer on a one-rank NCCL mesh of this process: the
    distributed tier alone and in PACOH-MAP and GPR-MLL, the mesh'd general
    steps of cauchy_20's SVGD and map_t5_n200's MAP, and the fan-out (the
    parallel SVGD step, the seed stack and the trials on a seed mesh, MLAP's
    meta-test) each against its run without a mesh."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from meta_learning_pacoh_torch import (
        GPRegressionLearned,
        GPRegressionMetaLearned,
        GPRegressionMetaLearnedSVGD,
    )
    from meta_learning_pacoh_torch.datasets import SinusoidDataset, provide_data
    from meta_learning_pacoh_torch.ops import cuda
    from meta_learning_pacoh_torch.parallel import (
        build_svgd_parallel_step,
        fit_models_parallel,
        make_mesh,
        make_seed_mesh,
    )
    from meta_learning_pacoh_torch.utils.tuning_parallel import fit_svgd_hyper_parallel

    mesh = make_mesh()
    print(f"  13: mesh {mesh.mesh_dim_names} {tuple(mesh.shape)} on {mesh.device_type}, "
          f"backend {dist.get_backend()}, world size {dist.get_world_size()}")
    summary = {"backend": dist.get_backend(), "world_size": dist.get_world_size()}
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    t0 = time.perf_counter()
    add(phase13a(mesh, summary))
    print(f"  13a: {time.perf_counter() - t0:.1f} s")

    # 13b: PACOH-MAP at its default widths on 5 tasks of 1,024 points
    env = SinusoidDataset(random_state=np.random.RandomState(13))
    train = env.generate_meta_train_data(n_tasks=MESH_MAP_TASKS, n_samples=MESH_MAP_POINTS)
    test = env.generate_meta_test_data(n_tasks=EVAL_TWIN_TASKS, n_samples_context=200,
                                       n_samples_test=200)

    def map_learner(**kw):
        return GPRegressionMetaLearned(train, task_batch_size=-1, random_seed=30, **kw)

    model = map_learner(mesh=mesh)
    if model._dist_linalg is None or model._fused_path_ok():
        raise AssertionError("13b: the N=1024 learner must take the distributed tier")
    counts = mesh_twin("map_n1024", model, map_learner, MESH_MAP_STEPS, summary)
    require_launches("map_n1024", counts, ("chol",), ("fused_map_bign", "fused_map"))
    add(counts)
    got = model.eval_datasets(test)
    twin = map_learner()
    twin.load_state_dict(model.state_dict())
    want = twin.eval_datasets(test)
    if not np.allclose(got, want, rtol=EVAL_TWIN_TOL, atol=EVAL_TWIN_TOL):
        raise AssertionError(f"13b eval: {got} against {want}")
    summary["map_n1024"]["eval"] = {"mesh": got, "no_mesh": want}
    print(f"  13b eval (LL, RMSE, calib) with the mesh {got}, without {want}")

    # 13c: GPR-MLL on one task of 2,048 points
    (x, y), = SinusoidDataset(random_state=np.random.RandomState(14)).generate_meta_train_data(
        n_tasks=1, n_samples=MESH_GPR_POINTS)
    gpr = GPRegressionLearned(x, y, random_seed=30, mesh=mesh)
    if gpr._dist_linalg is None:
        raise AssertionError("13c: the 2,048-point GPR-MLL must take the distributed tier")
    counts = mesh_twin("gpr_mll_n2048", gpr, lambda: GPRegressionLearned(x, y, random_seed=30),
                       MESH_GPR_STEPS, summary)
    require_launches("gpr_mll_n2048", counts, ("chol",))
    add(counts)

    # 13d: cauchy_20 PACOH-SVGD on the mesh: the general step (K1-K3)
    c_train, _ = cauchy20()
    model = cauchy_model(c_train, mesh=mesh)
    os.environ["PACOH_TORCH_DISABLE_FUSED"] = "1"
    try:
        counts = mesh_twin("cauchy_20", model, lambda: cauchy_model(c_train), MESH_SVGD_STEPS,
                           summary)
    finally:
        os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
    require_launches("cauchy_20", counts, ("svgd_phi", "mll_fwd", "mll_bwd"),
                     ("fused_svgd_bign", "fused_svgd"))
    add(counts)

    # 13e: map_t5_n200 on the mesh: the tasks sharded over one rank (B4)
    b_train, _ = bign_data()
    model = bign_model(b_train, mesh=mesh)
    os.environ["PACOH_TORCH_DISABLE_FUSED"] = "1"
    try:
        counts = mesh_twin("map_t5_n200", model, lambda: bign_model(b_train), MESH_STEPS,
                           summary)
    finally:
        os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
    require_launches("map_t5_n200", counts, ("blocked_fwd", "blocked_bwd"), ("fused_map_bign",))
    add(counts)

    # 13f: the fan-out on the mesh
    learner = cauchy_model(c_train)
    step, place = build_svgd_parallel_step(learner.hyper_prior, learner.prior_factor,
                                           learner._lr, mesh)
    particles, opt_state, X, Y, M = place(learner.particles.clone(), None, learner.X,
                                          learner.Y, learner.mask)
    cuda.reset_launch_counts()
    for _ in range(MESH_STEPS):
        particles, opt_state = step(particles, opt_state, X, Y, M)
    torch.cuda.synchronize()
    counts = launched()
    require_launches("parallel step", counts, ("svgd_phi", "mll_fwd", "mll_bwd"))
    add(counts)
    os.environ["PACOH_TORCH_DISABLE_FUSED"] = "1"
    try:
        learner.meta_fit(n_iter=MESH_STEPS, log_period=MESH_STEPS, verbose=False)
    finally:
        os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
    d = (particles - learner.particles).abs()
    same = bool(torch.equal(particles, learner.particles))
    if not (float(d.max()) <= TWIN_ATOL and float(d.mean()) <= TWIN_MEAN_ATOL):
        raise AssertionError(f"13f parallel step: |diff| {float(d.max()):.3e}")
    print(f"  13f build_svgd_parallel_step: {MESH_STEPS} steps against the learner's general "
          f"step, |diff| max {float(d.max()):.3e}, mean {float(d.mean()):.3e}; the bits "
          f"{'agree' if same else 'differ'} (launches {counts})")
    summary["parallel_step"] = {"steps": MESH_STEPS, "gap_max": float(d.max()),
                                "same_bits": same, "launches": counts}

    seed_mesh = make_seed_mesh()
    data = {seed: provide_data("cauchy_20", seed=seed) for seed in SWEEP_SEEDS}

    def seeds():
        return [GPRegressionMetaLearnedSVGD(data[seed][0], num_particles=10, random_seed=seed,
                                            task_batch_size=-1) for seed in SWEEP_SEEDS]

    meshed, plain = seeds(), seeds()
    cuda.reset_launch_counts()
    fit_models_parallel(meshed, n_iter=MESH_STEPS, mesh=seed_mesh)  # a mesh takes 'vmap'
    counts = launched()
    require_launches("seed stack", counts, ("svgd_phi", "mll_fwd", "mll_bwd"))
    add(counts)
    fit_models_parallel(plain, n_iter=MESH_STEPS, prefer="vmap")
    gap = twin_gaps("13f seed stack on a seed mesh against no mesh", meshed, plain,
                    (TWIN_ATOL, TWIN_MEAN_ATOL))
    same = all(torch.equal(twin_state(a), twin_state(b)) for a, b in zip(meshed, plain))
    summary["seed_stack"] = {"seeds": len(SWEEP_SEEDS), "steps": MESH_STEPS, "gap_max": gap[0],
                             "same_bits": same, "launches": counts}

    trials_train = sin20()[0]

    def trials():
        return [GPRegressionMetaLearnedSVGD(trials_train, num_particles=10, random_seed=30,
                                            task_batch_size=-1, lr=lr, prior_factor=pf)
                for lr, pf in ((1e-3, 0.01), (3e-3, 0.1), (1e-3, 0.1))]

    meshed, plain = trials(), trials()
    cuda.reset_launch_counts()
    fit_svgd_hyper_parallel(meshed, n_iter=MESH_STEPS, mesh=seed_mesh)
    counts = launched()
    add(counts)
    fit_svgd_hyper_parallel(plain, n_iter=MESH_STEPS)
    gap = twin_gaps("13f trials on a seed mesh against no mesh", meshed, plain,
                    (TWIN_ATOL, TWIN_MEAN_ATOL))
    same = all(torch.equal(twin_state(a), twin_state(b)) for a, b in zip(meshed, plain))
    summary["trials"] = {"trials": len(meshed), "steps": MESH_STEPS, "gap_max": gap[0],
                         "same_bits": same, "launches": counts}

    s_train, s_test = sin20()
    meshed = mlap_model(s_train, mesh=mesh)
    plain = mlap_model(s_train)
    plain.load_state_dict(meshed.state_dict())
    tasks = s_test[:MESH_MLAP_TASKS]
    cuda.reset_launch_counts()
    got = meshed.eval_datasets(tasks, n_iter_meta_test=MESH_MLAP_META_TEST)
    counts = launched()
    add(counts)
    want = plain.eval_datasets(tasks, n_iter_meta_test=MESH_MLAP_META_TEST)
    if not np.allclose(got, want, rtol=EVAL_TWIN_TOL, atol=EVAL_TWIN_TOL):
        raise AssertionError(f"13f MLAP meta-test: {got} against {want}")
    print(f"  13f MLAP meta-test of {len(tasks)} tasks sharded over the mesh "
          f"({MESH_MLAP_META_TEST} steps): eval {got}, without the mesh {want} "
          f"(launches {counts})")
    summary["mlap_meta_test"] = {"tasks": len(tasks), "steps": MESH_MLAP_META_TEST,
                                 "mesh": got, "no_mesh": want, "same": got == want,
                                 "launches": counts}
    dist.destroy_process_group()  # make_mesh's one-rank group
    return launches, summary


def cli_launches(label, run, expect=(), none=False):
    """Run ``run()`` with every launch count at 0 before; print and return its
    result, its launches and its seconds. Each kernel of ``expect`` must have
    launched; with ``none``, no kernel may have."""
    import torch

    from meta_learning_pacoh_torch.ops import cuda

    cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launched()
    print(f"  {label}: {seconds:.2f} s, launches {launches}")
    missing = [k for k in expect if not launches.get(k)]
    if missing or (none and launches):
        raise AssertionError(f"{label}: launches {launches}, expected {list(expect)}"
                             + (" and no other" if none else ""))
    return out, launches, seconds


def cli_direct(name, train, valid, test):
    """The learner a per-algorithm CLI builds for ``cli_argv(name)``, built here
    with its keywords written out, fitted and evaluated as run_experiment
    (maml_base_exp.main) does; returns its metrics."""
    from meta_learning_pacoh_torch import (
        GPRegressionMetaLearned,
        GPRegressionMetaLearnedPAC,
        GPRegressionMetaLearnedSVGD,
        GPRegressionMetaLearnedVI,
        MAMLRegression,
        NPRegressionMetaLearned,
    )

    nets = dict(mean_nn_layers=(32, 32), kernel_nn_layers=(32, 32), covar_module="NN",
                mean_module="NN", task_batch_size=5, normalize_data=True, lr_decay=1.0,
                random_seed=28, num_iter_fit=CLI_STEPS)
    prior = dict(prior_factor=0.01, weight_prior_std=0.5, bias_prior_std=3.0)
    if name == "maml_base_exp":
        model = MAMLRegression(train, layer_sizes=(32, 32), num_iter_fit=CLI_STEPS,
                               lr_inner=0.05, num_inner_steps=1, task_batch_size=5,
                               lr_meta=1e-3, lr_decay=1.0, random_seed=28)
        model.meta_fit(valid_tuples=valid[:10], log_period=1000)
        return {"test_rmse": model.eval_datasets(test)}
    if name == "npr_base_exp":
        model = NPRegressionMetaLearned(train, lr_params=1e-3, r_dim=50, z_dim=50, h_dim=50,
                                        num_iter_fit=CLI_STEPS, weight_decay=1e-2,
                                        task_batch_size=5, normalize_data=True, lr_decay=1.0,
                                        random_seed=28)
    elif name == "meta_gpr_mll_base_exp":
        model = GPRegressionMetaLearned(train, learning_mode="both", lr_params=1e-3,
                                        weight_decay=0.0, feature_dim=2, **nets)
    elif name == "meta_gpr_svgd_base_exp":
        model = GPRegressionMetaLearnedSVGD(train, feature_dim=1, lr=1e-3, kernel="RBF",
                                            bandwidth=None, num_particles=10, **prior, **nets)
    elif name == "meta_gpr_vi_base_exp":
        model = GPRegressionMetaLearnedVI(train, feature_dim=1, lr=1e-3, svi_batch_size=10,
                                          cov_type="diag", **prior, **nets)
    else:
        model = GPRegressionMetaLearnedPAC(train, feature_dim=1, task_kl_weight=1.0,
                                           meta_kl_weight=1e-5, posterior_lr_multiplier=5.0,
                                           lr=1e-3, svi_batch_size=5, cov_type="diag", **nets)
    model.meta_fit(valid_tuples=valid[:10], log_period=1000, n_iter=CLI_STEPS)
    return dict(zip(("test_ll", "test_rmse", "calib_err"), model.eval_datasets(test)))


def cli_argv(name, data_dir):
    """A per-algorithm CLI's command line: the defaults (nets (32, 32),
    sin_20) with CLI_STEPS steps; SVGD, VI and MLAP with --feature_dim 1,
    the learners' own default, which their fused kernels take (the CLI's
    default of 2 sends them to the general step)."""
    argv = ["--n_iter_fit", str(CLI_STEPS), "--data_dir", data_dir]
    if name in ("meta_gpr_svgd_base_exp", "meta_gpr_vi_base_exp", "meta_mlap_base_exp"):
        argv += ["--feature_dim", "1"]
    if name == "meta_mlap_base_exp":
        argv += ["--n_iter_meta_test", str(CLI_MLAP_META_TEST)]
    return argv


def phase14_algos(tmp, summary):
    """The six per-algorithm CLIs: results.json finite, the run directory
    named by hash_dict of config.json's flags, the expected kernels launched,
    and the metrics the bits of the learner built directly."""
    import importlib

    from meta_learning_pacoh_torch.datasets import provide_data
    from meta_learning_pacoh_torch.utils.experiment import hash_dict

    train, valid, test = provide_data("sin_20", seed=28)
    for name, (exp_name, expect) in CLI_KERNELS.items():
        cli = importlib.import_module(f"meta_learning_pacoh_torch.experiments.{name}")
        data_dir = os.path.join(tmp, "exp_results")
        results, launches, seconds = cli_launches(
            name, lambda: cli.main(cli_argv(name, data_dir)), expect, none=not expect)
        (run_dir,) = os.listdir(os.path.join(data_dir, exp_name))
        with open(os.path.join(data_dir, exp_name, run_dir, "config.json")) as f:
            config = json.load(f)
        with open(os.path.join(data_dir, exp_name, run_dir, "results.json")) as f:
            written = json.load(f)
        config.pop("timestamp")
        if run_dir != hash_dict(config):
            raise AssertionError(f"{name}: run directory {run_dir} is not hash_dict of its flags")
        if written != results or not all(math.isfinite(v) for v in written.values()):
            raise AssertionError(f"{name}: results.json {written} is not finite or not returned")
        direct = cli_direct(name, train, valid, test)
        same = all(written[k] == v for k, v in direct.items())
        print(f"    results {json.dumps(written)}; the learner built directly: "
              f"{json.dumps(direct)}; the same bits: {same}")
        if not same:
            raise AssertionError(f"{name}: the CLI's metrics differ from the direct learner's")
        summary[name] = {"seconds": seconds, "launches": launches, **written}


def phase14_sweeps(tmp, summary):
    """The baseline comparison (and its n-tasks variant and summary) and the
    meta-overfitting sweep with and without --seed_parallel."""
    from meta_learning_pacoh_torch.experiments._cli import read_csv
    from meta_learning_pacoh_torch.experiments.baselines import (
        baseline_comparison,
        baseline_comparison_n_tasks,
        summarize_baselines,
    )
    from meta_learning_pacoh_torch.experiments.meta_overfitting import run_overfitting_sweep

    csv_path = os.path.join(tmp, "baseline_comparison.csv")
    out, launches, seconds = cli_launches(
        "baseline_comparison", lambda: baseline_comparison.main(
            ["--datasets", "sin_20", "--seeds", "22", "--n_iter_fit", str(CLI_SWEEP_STEPS),
             "--n_test_tasks", "10", "--output_csv", csv_path]),
        ("fused_map", "fused_svgd", "fused_vi"))
    metric_keys = ("test_ll", "test_rmse", "calib_err", "fit_time")
    for row in out.rows:  # MAML's row has no LL or calibration, as the original writes it
        keys = ("test_rmse", "fit_time") if row["algo"] == "maml" else metric_keys
        if not all(math.isfinite(row[k]) for k in keys):
            raise AssertionError(f"baseline_comparison: a row is not finite: {row}")
    if out.failed or len(out.rows) != 5 or len(read_csv(csv_path)) != 5:
        raise AssertionError(f"baseline_comparison: {len(out.rows)} rows, {out.failed} failed")
    summary["baseline_comparison"] = {"seconds": seconds, "launches": launches,
                                      "rows": len(out.rows), "failed": out.failed}

    n_csv = os.path.join(tmp, "baseline_comparison_n_tasks.csv")
    out, launches, seconds = cli_launches(
        "baseline_comparison_n_tasks", lambda: baseline_comparison_n_tasks.main(
            ["--base_datasets", "sin", "--n_tasks_grid", "5", "--algos", "pacoh_map",
             "--seeds", "22,23", "--n_iter_fit", str(CLI_SWEEP_STEPS), "--n_test_tasks", "10",
             "--output_csv", n_csv]), ("fused_map",))
    if out.failed or [r["dataset"] for r in out.rows] != ["sin_5", "sin_5"] or not all(
            math.isfinite(r[k]) for r in out.rows for k in metric_keys):
        raise AssertionError(f"baseline_comparison_n_tasks: {out}")
    summary["baseline_comparison_n_tasks"] = {"seconds": seconds, "launches": launches,
                                              "rows": len(out.rows), "failed": out.failed}

    stats, launches, _ = cli_launches(
        "summarize_baselines", lambda: summarize_baselines.main(["--csv", csv_path]), none=True)
    by_algo = {key[1]: vals for key, vals in stats}
    rows = {r["algo"]: r for r in read_csv(csv_path)}
    if sorted(by_algo) != sorted(rows) or any(
            v["n_seeds"] != 1 or v["rmse_mean"] != rows[a]["test_rmse"]
            for a, v in by_algo.items()):
        raise AssertionError("summarize_baselines: the summary does not match the CSV")

    runs = {}
    for label, extra in (("seed_parallel", ["--seed_parallel"]), ("sequential", [])):
        out, launches, seconds = cli_launches(
            f"run_overfitting_sweep {label}", lambda: run_overfitting_sweep.main(
                ["--algo", "pacoh_map", "--n_tasks_grid", "4,8", "--weight_decay_grid", "0.1",
                 "--seeds", "22,23,24", "--n_iter_fit", str(CLI_SWEEP_STEPS),
                 "--output_csv", os.path.join(tmp, f"meta_overfitting_{label}.csv")] + extra),
            ("fused_map",))
        if out.failed or out.fell_back or len(out.rows) != 6:
            raise AssertionError(f"run_overfitting_sweep {label}: {len(out.rows)} rows, "
                                 f"{out.failed} failed, {out.fell_back} fell back")
        runs[label] = out.rows
        summary[f"run_overfitting_sweep {label}"] = {
            "seconds": seconds, "launches": launches, "rows": len(out.rows),
            "failed": out.failed, "fell_back": out.fell_back}
    metrics = [k for k in runs["sequential"][0] if k.startswith(("test_", "calib"))]
    same = all(a[k] == b[k] for a, b in zip(runs["seed_parallel"], runs["sequential"])
               for k in metrics)
    print(f"    the sweep's metric columns with and without --seed_parallel: the same bits: "
          f"{same}")
    if not same or not all(math.isfinite(r[k]) for r in runs["sequential"] for k in metrics):
        raise AssertionError("run_overfitting_sweep: --seed_parallel changes the metrics")


def phase14_search(tmp, summary):
    """The hyperparameter search (SVGD trials stacked, the re-evaluation
    seeds fitted together; MAP trials stacked) and the launcher's commands."""
    import shlex

    from meta_learning_pacoh_torch.experiments.hyperparam_search import (
        launch_hyperparam_sweeps,
        meta_hyperparam_search,
    )

    small = ["--num_samples", "4", "--trial_batch_size", "2", "--n_iter_fit",
             str(CLI_SEARCH_STEPS), "--n_eval_tasks", "10", "--top_n", "1", "--n_test_seeds", "2",
             "--local_dir", os.path.join(tmp, "tune_out")]
    # the SVGD space draws a numeric bandwidth, whose transport is the plain RBF
    # one (K1 is the median heuristic's): its trials and seeds launch K4 in the evals
    for algo, extra, expect in (("pacoh_svgd", ["--seed_parallel"], ("chol",)),
                                ("pacoh_map", [], ("fused_map",))):
        out, launches, seconds = cli_launches(
            f"meta_hyperparam_search {algo}",
            lambda: meta_hyperparam_search.main(["--algo", algo] + small + extra), expect)
        path = os.path.join(tmp, "tune_out", f"best_configs_{algo}_sin_20.csv")
        if out.failed or out.fell_back or len(out.rows) != 2 or not os.path.exists(path):
            raise AssertionError(f"meta_hyperparam_search {algo}: {len(out.rows)} rows, "
                                 f"{out.failed} trials failed, {out.fell_back} batches fell "
                                 f"back")
        summary[f"meta_hyperparam_search {algo}"] = {
            "seconds": seconds, "launches": launches, "rows": len(out.rows),
            "failed": out.failed, "fell_back": out.fell_back}

    commands = launch_hyperparam_sweeps.main([])
    grid = set()
    for cmd in commands:
        words = shlex.split(cmd)
        if words[1:3] != ["-m", launch_hyperparam_sweeps.SEARCH_MODULE]:
            raise AssertionError(f"launcher: {cmd!r} does not run the port's search")
        args = meta_hyperparam_search.parser().parse(words[3:])
        grid.add((args.dataset, args.algo))
    if len(commands) != 6 or len(grid) != 6:
        raise AssertionError(f"launcher: {commands}")
    print(f"    launcher: {len(commands)} commands, each parsed by the search's parser")


def phase14_np_img(tmp, summary):
    """The image NP driver on synthetic IDX images: finite losses, and
    model.pkl loads into a fresh model with the same predictions as the same
    training run driven directly."""
    import pickle

    import numpy as np

    from meta_learning_pacoh_torch.datasets.np_image_data import mnist_image_batches
    from meta_learning_pacoh_torch.experiments import np_image_experiment
    from meta_learning_pacoh_torch.models.neural_process_img import (
        NeuralProcessImg,
        NeuralProcessImgTrainer,
        batch_context_target_mask,
    )

    synthetic_idx_images(os.path.join(tmp, "train-images-idx3-ubyte.gz"), NP_IMG_IMAGES)
    config = {"dataset": "mnist", "img_size": [1, 28, 28], "batch_size": NP_IMG_BATCH,
              "r_dim": 128, "h_dim": 128, "z_dim": 128, "num_context_range": [3, 50],
              "num_extra_target_range": [5, 50], "epochs": 1, "lr": 1e-3,
              "path_to_data": tmp, "limit": NP_IMG_IMAGES, "seed": 0}
    config_path = os.path.join(tmp, "np_config.json")
    with open(config_path, "w") as f:
        json.dump({**config, "results_dir": os.path.join(tmp, "np_results")}, f)
    (losses, results_dir), launches, seconds = cli_launches(
        "np_image_experiment", lambda: np_image_experiment.main([config_path]), none=True)
    with open(os.path.join(results_dir, "losses.json")) as f:
        written = json.load(f)
    with open(os.path.join(results_dir, "model.pkl"), "rb") as f:
        saved = pickle.load(f)
    if written != losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"np_image_experiment: losses {losses}, losses.json {written}")

    rs = np.random.RandomState(0)
    batches = mnist_image_batches(batch_size=NP_IMG_BATCH, size=28, path_to_data=tmp,
                                  random_state=rs, limit=NP_IMG_IMAGES)
    direct = NeuralProcessImg((1, 28, 28), r_dim=128, z_dim=128, h_dim=128, random_seed=0)
    NeuralProcessImgTrainer(direct, lr=1e-3, num_context_range=(3, 50),
                            num_extra_target_range=(5, 50)).train(batches, 1)
    loaded = NeuralProcessImg((1, 28, 28), r_dim=128, z_dim=128, h_dim=128, random_seed=0)
    loaded.load_params(saved["params"])
    loaded._generator.set_state(direct._generator.get_state())
    img = batches.images[0]
    cm, _ = batch_context_target_mask((1, 28, 28), 50, 100, 1,
                                      random_state=np.random.RandomState(1))
    want = direct.inpaint(img, cm[0])
    got = loaded.inpaint(img, cm[0])
    same = all(np.array_equal(a, b) for a, b in zip(got, want)) and saved["config"] == {
        **config, "results_dir": os.path.join(tmp, "np_results")}
    print(f"    losses {losses}; model.pkl ({len(saved['params'])} arrays) in a fresh model "
          f"predicts the directly trained model's bits: {same}")
    if not same:
        raise AssertionError("np_image_experiment: model.pkl does not give the trained model")
    summary["np_image_experiment"] = {"seconds": seconds, "launches": launches,
                                      "losses": losses}


def phase14_demo(tmp, summary, reference):
    """The demo in full (in ``tmp``, where it may write its plot): its LL, RMSE
    and calibration the bits of ``reference`` (phase 5's demo fit)."""
    from meta_learning_pacoh_torch import demo

    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        got, launches, seconds = cli_launches("demo", lambda: demo.main([]), ("fused_map",))
    finally:
        os.chdir(cwd)
    same = tuple(got) == tuple(reference)
    print(f"    demo LL, RMSE, calibration {got}; phase 5's demo fit {tuple(reference)}; "
          f"the same bits: {same}")
    if not same:
        raise AssertionError("demo: its metrics differ from phase 5's demo fit")
    summary["demo"] = {"seconds": seconds, "launches": launches,
                       **dict(zip(("ll", "rmse", "calib"), got))}


def phase14(demo_reference=None):
    """The experiment CLIs in this process through their main(argv), on the
    card by default, into a temporary directory. ``demo_reference``: phase
    5's (LL, RMSE, calibration); None fits phase 5's demo learner here."""
    import tempfile

    if demo_reference is None:
        train, test = sin20()
        model = demo_model(train)
        model.meta_fit(n_iter=MAP_STEPS, log_period=MAP_STEPS, verbose=False)
        demo_reference = model.eval_datasets(test)
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        phase14_algos(tmp, summary)
        phase14_sweeps(tmp, summary)
        phase14_search(tmp, summary)
        phase14_np_img(tmp, summary)
        phase14_demo(tmp, summary, demo_reference)
    return summary


def phase15_fit(label, build, kernel, general, summary):
    """A learner of ``build()`` fitted MANY_STEPS steps by its fused kernel
    alone, then by its general step (``PACOH_TORCH_DISABLE_FUSED=1``, the
    wall only); returns the fused learner."""
    model = build()
    if model.device.type != "cuda" or not model._fused_path_ok():
        raise AssertionError(f"{label}: on {model.device}, or off the fused path")
    _, launches, fit_s = cli_launches(
        f"{label}: {MANY_STEPS}-step fit", lambda: model.meta_fit(
            n_iter=MANY_STEPS, log_period=MANY_STEPS, verbose=False), (kernel,))
    want = len(list(model._fused.launches(0, MANY_STEPS)))
    if launches != {kernel: want}:
        raise AssertionError(f"{label}: the fit was not carried by {kernel} alone in {want} "
                             f"launches: {launches}")
    os.environ["PACOH_TORCH_DISABLE_FUSED"] = "1"
    try:
        twin = build()
        _, general_launches, general_s = cli_launches(
            f"{label}: the same fit, PACOH_TORCH_DISABLE_FUSED=1", lambda: twin.meta_fit(
                n_iter=MANY_STEPS, log_period=MANY_STEPS, verbose=False), general)
    finally:
        os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
    if general_launches.get(kernel):
        raise AssertionError(f"{label}: the general step launched {kernel}")
    print(f"  {label}: walls {fit_s:.3f} s ({kernel}), {general_s:.3f} s (the general step), "
          f"{general_s / fit_s:.1f}x")
    summary[label] = {"fit_s": fit_s, "general_fit_s": general_s, "launches": launches}
    return model


def phase15_twins(label, build, state, test, summary):
    """TWIN_STEPS steps from ``state`` by the fused kernel and by the general
    step, held to the twin limits, and their evals to EVAL_TWIN_TOL."""
    import numpy as np

    twins = []
    for disabled in ("0", "1"):
        os.environ["PACOH_TORCH_DISABLE_FUSED"] = disabled
        try:
            twin = build()
            twin.load_state_dict(state)
            if twin._fused_path_ok() != (disabled == "0"):
                raise AssertionError(f"{label}: PACOH_TORCH_DISABLE_FUSED={disabled}: wrong path")
            twin.meta_fit(n_iter=TWIN_STEPS, log_period=TWIN_STEPS, verbose=False)
            twins.append((twin, np.asarray(twin.eval_datasets(test[:EVAL_TWIN_TASKS]))))
        finally:
            os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
    gap = twin_gaps(f"{label}: {TWIN_STEPS} steps from the fit's state, fused - general",
                    [twins[0][0]], [twins[1][0]], (TWIN_ATOL, TWIN_MEAN_ATOL))
    print(f"    evals ({EVAL_TWIN_TASKS} tasks): fused {twins[0][1].tolist()}, general "
          f"{twins[1][1].tolist()}")
    if not np.allclose(twins[0][1], twins[1][1], rtol=EVAL_TWIN_TOL, atol=EVAL_TWIN_TOL):
        raise AssertionError(f"{label}: the fused and general twins' evals disagree")
    summary[label]["twin_max"], summary[label]["twin_mean"] = gap


def phase15():
    """Many tasks through the learners' entry points (see the top of this
    file); returns (launches of the fused kernels, summary)."""
    import numpy as np
    import torch

    from meta_learning_pacoh_torch.datasets import SinusoidDataset, provide_data
    from meta_learning_pacoh_torch.experiments.baselines.baseline_comparison import build_cell
    from meta_learning_pacoh_torch.ops import cuda

    summary, total = {}, {}
    for dataset in ("sin_160", "sin_320"):
        train, _, test = provide_data(dataset, seed=22)
        for algo, kernel, general in (("pacoh_svgd", "fused_svgd", ("svgd_phi",)),
                                      ("pacoh_vi", "fused_vi", ())):
            label = f"{dataset} {algo}"

            def build(algo=algo, train=train):
                return build_cell(algo, train, 22, MANY_STEPS)

            model = phase15_fit(label, build, kernel, general, summary)
            total[kernel] = total.get(kernel, 0) + summary[label]["launches"][kernel]
            phase15_twins(label, build, model.state_dict(), test, summary)

    # PACOH-MLAP: the fit on sin_160, held on a conditioned state as phase 8
    train, _, _ = provide_data("sin_160", seed=22)
    phase15_fit("sin_160 pacoh_mlap", lambda: mlap_model(train), "fused_mlap", (), summary)
    total["fused_mlap"] = summary["sin_160 pacoh_mlap"]["launches"]["fused_mlap"]
    rs = np.random.RandomState(15)
    tasks = conditioned_tasks(rs, 160, 5)
    model = mlap_model(tasks)
    state = conditioned_state(model, rs)
    twins = {}
    for label, disabled in (("fused", "0"), ("general", "1")):
        os.environ["PACOH_TORCH_DISABLE_FUSED"] = disabled
        try:
            twin = mlap_model(tasks)
            twin.load_state_dict(state)
            twin.meta_fit(n_iter=MLAP_TWIN_STEPS, log_period=MLAP_TWIN_STEPS, verbose=False)
            twins[label] = (twin, twin.meta_fit(n_iter=1, log_period=1, verbose=False)[0])
        finally:
            os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
    skip = model.hyper_prior.slice_of(("kernel_nn", "b_out"))
    summary["sin_160 pacoh_mlap"]["twin_max"] = compare_mlap(
        f"160 conditioned tasks, B8 against the general step, {MLAP_TWIN_STEPS} steps from one "
        f"state and the next step's loss", mlap_state(twins["fused"][0]),
        mlap_state(twins["general"][0]), twins["fused"][1], twins["general"][1], skip)

    # the MLAP CLI's eval: 200 test tasks through B8's meta-test mode
    env = SinusoidDataset(random_state=np.random.RandomState(26))
    train = env.generate_meta_train_data(n_tasks=20, n_samples=5)
    test = env.generate_meta_test_data(n_tasks=MANY_EVAL_TASKS, n_samples_context=5,
                                       n_samples_test=50)
    metrics, walls, eval_launches = [], [], 0
    for seed in SIN_SEEDS:
        model = mlap_model(train, seed=seed)
        model.meta_fit(n_iter=MLAP_STEPS, log_period=MLAP_STEPS, verbose=False)
        if not model._fused_meta_test_ok(MANY_EVAL_TASKS, 5, 1):
            raise AssertionError("the 200-task meta-test is off the kernel's meta-test mode")
        out, launches, seconds = cli_launches(
            f"seed {seed}: eval_datasets of {MANY_EVAL_TASKS} test tasks "
            f"({MLAP_META_TEST}-step meta-test)",
            lambda: model.eval_datasets(test, n_iter_meta_test=MLAP_META_TEST),
            ("fused_mlap",))
        want = len(range(0, MLAP_META_TEST, 512))
        if launches.get("fused_mlap") != want:
            raise AssertionError(f"the eval's meta-test took {launches}, not {want} B8 launches")
        metrics.append(out)
        walls.append(seconds)
        eval_launches += launches["fused_mlap"]
    total["fused_mlap"] += eval_launches
    lls, rmses = [m[0] for m in metrics], [m[1] for m in metrics]
    mean_ll, mean_rmse = float(np.mean(lls)), float(np.mean(rmses))
    with open(MLAP_BAND_FILE) as f:
        band = json.load(f)["jax"]
    ll_band, rmse_band = band["ll_band"], band["rmse_band"]
    print(f"  seeds {SIN_SEEDS}, {MANY_EVAL_TASKS} test tasks: LL {lls}, RMSE {rmses}; mean LL "
          f"{mean_ll:.4f} (band {ll_band[0]:.4f} +- {ll_band[1]:.4f}), mean RMSE "
          f"{mean_rmse:.4f} (band {rmse_band[0]:.4f} +- {rmse_band[1]:.4f})")
    if not (abs(mean_ll - ll_band[0]) <= ll_band[1]
            and abs(mean_rmse - rmse_band[0]) <= rmse_band[1]):
        raise AssertionError("the 200-task MLAP eval lies outside the JAX package's band")
    short = {}
    for label, disabled in (("B8", "0"), ("general", "1")):
        os.environ["PACOH_TORCH_DISABLE_FUSED"] = disabled
        try:
            _, launches, short[label] = cli_launches(
                f"seed {SIN_SEEDS[-1]}: eval_datasets, {MLAP_CI_META_TEST}-step meta-test, "
                f"PACOH_TORCH_DISABLE_FUSED={disabled}",
                lambda: model.eval_datasets(test, n_iter_meta_test=MLAP_CI_META_TEST))
        finally:
            os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
        if bool(launches.get("fused_mlap")) != (label == "B8"):
            raise AssertionError(f"the {label} eval's launches: {launches}")
        if label == "B8":
            total["fused_mlap"] += launches["fused_mlap"]
    print(f"  {MANY_EVAL_TASKS}-task eval, {MLAP_CI_META_TEST}-step meta-test: walls "
          f"{short['B8']:.3f} s (B8), {short['general']:.3f} s (the general loop), "
          f"{short['general'] / short['B8']:.1f}x")
    # B8's meta-test of 200 conditioned context sets against the general loop
    ctx = conditioned_tasks(rs, MANY_EVAL_TASKS, 5)
    got = {}
    for label, disabled in (("B8", "0"), ("general", "1")):
        os.environ["PACOH_TORCH_DISABLE_FUSED"] = disabled
        try:
            twin = mlap_model(tasks)
            twin.load_state_dict(state)
            got[label] = twin._meta_test_inference(ctx, n_iter=MLAP_TWIN_STEPS)
        finally:
            os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
    gaps = [(got["B8"][k] - got["general"][k]).abs() for k in ("q_means", "q_trils")]
    d_max, d_mean = max(float(g.max()) for g in gaps), max(float(g.mean()) for g in gaps)
    print(f"  {MANY_EVAL_TASKS} conditioned context sets, {MLAP_TWIN_STEPS}-step meta-test, B8 - "
          f"general: |q_means, q_trils diff| max {d_max:.3e}, mean {d_mean:.3e} (limits "
          f"{TWIN_ATOL}, {TWIN_MEAN_ATOL})")
    if not (d_max <= TWIN_ATOL and d_mean <= TWIN_MEAN_ATOL):
        raise AssertionError("the 200-task meta-test: B8 and the general loop disagree")
    torch.cuda.synchronize()
    summary["mlap_eval_200"] = dict(ll=lls, rmse=rmses, mean_ll=mean_ll, mean_rmse=mean_rmse,
                                    eval_s=walls, eval_300_b8_s=short["B8"],
                                    eval_300_general_s=short["general"], launches=eval_launches,
                                    meta_test_twin=(d_max, d_mean))
    return total, summary


COMPARE_KERNELS = {"PACOH-MAP": "fused_map", "PACOH-SVGD": "fused_svgd",
                   "PACOH-VI": "fused_vi", "PACOH-MLAP": "fused_mlap"}
COMPARE_TWIN_ARGV = ["--n_iter", "100", "--n_repeats", "1"]
COMPARE_META_TEST_LAUNCH = 512  # steps a launch of B8's meta-test mode


class CallLog:
    """Records, around every ``meta_fit`` and ``eval_datasets`` of the classes
    given, the kernel launches the call made (read from the counts, never
    reset), its steps, and whether the learner was on its fused path. The
    classes' methods are restored on exit."""

    def __init__(self, classes):
        self.classes, self.calls, self._saved = classes, [], []

    def __enter__(self):
        for cls in self.classes:
            for name in ("meta_fit", "eval_datasets"):
                orig = cls.__dict__.get(name) or getattr(cls, name)
                self._saved.append((cls, name, cls.__dict__.get(name)))
                setattr(cls, name, self._wrap(cls.__name__, name, orig))
        return self

    def __exit__(self, *exc):
        for cls, name, orig in reversed(self._saved):
            if orig is None:
                delattr(cls, name)
            else:
                setattr(cls, name, orig)

    def _wrap(self, learner, call, orig):
        def wrapped(model, *args, **kw):
            before, step0 = launched(), model._step_count
            out = orig(model, *args, **kw)
            after = launched()
            diff = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
            record = {"learner": learner, "call": call, "launches": diff,
                      "fused": model._fused_path_ok(), "steps": model._step_count - step0,
                      "kw": {k: v for k, v in kw.items() if isinstance(v, (int, float, bool))}}
            if call == "meta_fit" and record["fused"]:
                record["planned"] = len(list(model._fused.launches(step0, record["steps"])))
            self.calls.append(record)
            return out
        return wrapped


def compare_run(label, argv, out_path):
    """The computational comparison's main(argv) with ``--output out_path``,
    its calls logged; returns (results, launches, seconds, the call log)."""
    from meta_learning_pacoh_torch import (
        GPRegressionMetaLearned,
        GPRegressionMetaLearnedPAC,
        GPRegressionMetaLearnedSVGD,
        GPRegressionMetaLearnedVI,
    )
    from meta_learning_pacoh_torch.experiments import computational_comparison

    classes = (GPRegressionMetaLearned, GPRegressionMetaLearnedSVGD, GPRegressionMetaLearnedVI,
               GPRegressionMetaLearnedPAC)
    with CallLog(classes) as log:
        results, launches, seconds = cli_launches(
            label, lambda: computational_comparison.main(argv + ["--output", out_path]))
    with open(out_path) as f:
        written = json.load(f)
    if written != results:
        raise AssertionError(f"{label}: the written JSON {written} is not the returned {results}")
    for name, row in results.items():
        if not all(math.isfinite(v) and v > 0 for v in row.values()):
            raise AssertionError(f"{label}: {name}: {row} not finite and positive")
    return results, launches, seconds, log.calls


def phase16(argv=()):
    """The port's computational comparison through its main(argv), by default
    at its defaults (1,000-step fits, one cold and five warm a learner, two
    evals of five sin_20 test tasks, MLAP's with a 1,000-step meta-test), on
    the card by default: each learner's fits carried by its fused kernel
    alone in the planned launches, MLAP's meta-tests by B8's meta-test mode,
    the rows finite and positive and the written JSON the returned dict;
    then the twin at COMPARE_TWIN_ARGV with PACOH_TORCH_DISABLE_FUSED=1 (the
    general steps). Returns (the main run's launches, summary)."""
    import tempfile

    from meta_learning_pacoh_torch.experiments.computational_comparison import parser

    n_fits = 1 + parser().parse(list(argv)).n_repeats
    with tempfile.TemporaryDirectory() as tmp:
        results, launches, seconds, calls = compare_run(
            "computational comparison " + (" ".join(argv) or "at its defaults"), list(argv),
            os.path.join(tmp, "main.json"))
        names = {"GPRegressionMetaLearned": "PACOH-MAP", "GPRegressionMetaLearnedSVGD":
                 "PACOH-SVGD", "GPRegressionMetaLearnedVI": "PACOH-VI",
                 "GPRegressionMetaLearnedPAC": "PACOH-MLAP"}
        per_learner = {}
        for c in calls:
            name = names[c["learner"]]
            kernel = COMPARE_KERNELS[name]
            if c["call"] == "meta_fit":
                if not c["fused"] or c["launches"] != {kernel: c["planned"]}:
                    raise AssertionError(f"{name}: a fit off its fused kernel {kernel} "
                                         f"alone: {c}")
            elif name == "PACOH-MLAP":
                want = len(range(0, c["kw"]["n_iter_meta_test"], COMPARE_META_TEST_LAUNCH))
                if c["launches"].get("fused_mlap") != want:
                    raise AssertionError(f"MLAP's eval: not {want} launches of B8's meta-test "
                                         f"mode: {c}")
            elif any(k.startswith("fused_") for k in c["launches"]):
                raise AssertionError(f"{name}'s eval launched a fused kernel: {c}")
            entry = per_learner.setdefault(name, {"meta_fit": [], "eval_datasets": []})
            entry[c["call"]].append(c["launches"])
        if [len(v["meta_fit"]) for v in per_learner.values()] != [n_fits] * 4 or \
                [len(v["eval_datasets"]) for v in per_learner.values()] != [2] * 4:
            raise AssertionError(f"the calls were not {n_fits} fits and 2 evals a learner: "
                                 f"{calls}")
        for name, kernel in COMPARE_KERNELS.items():
            print(f"    {name}: fits {per_learner[name]['meta_fit'][0]} each "
                  f"({kernel}), evals {per_learner[name]['eval_datasets']}")

        os.environ["PACOH_TORCH_DISABLE_FUSED"] = "1"
        try:
            twin, twin_launches, twin_s, twin_calls = compare_run(
                "the same at " + " ".join(COMPARE_TWIN_ARGV) + ", PACOH_TORCH_DISABLE_FUSED=1",
                list(COMPARE_TWIN_ARGV), os.path.join(tmp, "twin.json"))
        finally:
            os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
        if any(k.startswith("fused_") for k in twin_launches) or any(
                c["fused"] for c in twin_calls):
            raise AssertionError(f"the general-step twin took a fused path: {twin_launches}")
    for name in results:
        row, general = results[name], twin[name]
        print(f"  {name}: {row['train_iter_ms_warm']:.5f} ms/iter warm (general step "
              f"{general['train_iter_ms_warm']:.5f}, "
              f"{general['train_iter_ms_warm'] / row['train_iter_ms_warm']:.1f}x), cold fit "
              f"{row['train_cold_total_s']:.4f} s; meta-test {row['meta_test_per_task_s_warm']:.6f}"
              f" s/task warm (general {general['meta_test_per_task_s_warm']:.6f}), cold eval "
              f"{row['meta_test_cold_total_s']:.4f} s")
    return launches, {"results": results, "general_twin": twin,
                      "twin_argv": COMPARE_TWIN_ARGV, "seconds": seconds,
                      "twin_seconds": twin_s, "launches": launches,
                      "twin_launches": twin_launches}


def report_one_system():
    """Print phase 2's times at one system a launch, now that the calls that
    read back to the host have their kernels' sums, and whether each kernel
    loses to its library call."""
    for name, rec in ONE_SYSTEM.items():
        rec["plain_timed_as"] = TIMED_AS.get(f"{name} at B=1 plain")
        rec["library_timed_as"] = TIMED_AS.get(f"{name} at B=1 library")
        lose = " (slower than the library call)" if rec["ms"] > rec["library_ms"] else ""
        print(f"  {name} at B=1: kernel {rec['ms']:.5f} ms, plain {rec['plain_ms']:.5f} ms "
              f"({rec['plain_timed_as']}), library {rec['library_ms']:.5f} ms "
              f"({rec['library_timed_as']}){lose}, bound {rec['bound_ms']:.6f} ms "
              f"({rec['bound_by']})")


def bound_record(pair_ms, library_ms, flops, n_bytes):
    """A B=1 timing with its bound: the larger of the flops over the card's
    float32 peak and the bytes over its memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS, n_bytes / PEAK_BYTES
    return {"ms": pair_ms[0], "plain_ms": pair_ms[1], "library_ms": library_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="trace fit steps and one eval of each main path with "
                             "torch.profiler; write the tables into DIR")
    args = parser.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    card = card_line()
    print(f"phase 0: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {card}")

    from meta_learning_pacoh_torch.models.random_gp import make_hyper_prior, random_gp_config
    from meta_learning_pacoh_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.library()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_info['seconds']:.2f} s) -> {build.build_info['path']}")
    for line in build.build_info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("   ", line.strip())

    param_dim = make_hyper_prior(random_gp_config(2, feature_dim=1)).dim
    print(f"phase 2: kernels against their plain versions (P={param_dim})")
    errs, times, work, library = phase2(param_dim)

    print("phase 3: cauchy_20 PACOH-SVGD main paths (NN/NN: B10; SE covariance: the general "
          "step, K1-K4)")
    launches, summary = phase3(args.profile)
    print("slice cauchy_20: " + json.dumps({"card": card, **summary}))

    print("phase 4: sin_20 PACOH-SVGD main path (fused kernel)")
    sin_launches, sin_summary = phase4(args.profile)
    launches["fused_svgd"] = sin_launches["fused_svgd"]
    print("slice sin_20: " + json.dumps({"card": card, **sin_summary}))

    print("phase 5: PACOH-MAP demo main path (fused kernel)")
    map_launches, map_summary = phase5(args.profile)
    launches["fused_map"] = map_launches["fused_map"]
    print("slice map demo: " + json.dumps({"card": card, **map_summary}))

    print("phase 6: sin_20 PACOH-VI main path (fused kernel)")
    vi_launches, vi_summary = phase6(args.profile)
    launches["fused_vi"] = vi_launches["fused_vi"]
    print("slice sin_20 VI: " + json.dumps({"card": card, **vi_summary}))

    print("phase 7: map_t5_n200 PACOH-MAP main path (big-N fused kernel; general step B4)")
    bign_launches, bign_summary = phase7(args.profile)
    for name in ("fused_map_bign", "blocked_fwd", "blocked_bwd"):
        launches[name] = bign_launches[name]
    print("slice map_t5_n200: " + json.dumps({"card": card, **bign_summary}))

    print("phase 8: sin_20 PACOH-MLAP main path (fused kernel; its eval through B5)")
    mlap_launches, mlap_summary = phase8(args.profile)
    for name in ("fused_mlap", "chol_small"):
        launches[name] = mlap_launches[name]
    print("slice sin_20 MLAP: " + json.dumps({"card": card, **mlap_summary}))

    print("phase 9: svgd_t5_n200 and vi_t5_n200 main paths (big-N fused kernels B10, B11)")
    bign_fused_launches, bign_fused_summaries = phase9(args.profile)
    launches.update(bign_fused_launches)
    for name, summary in bign_fused_summaries.items():
        print(f"slice {name}: " + json.dumps({"card": card, **summary}))

    print("phase 10: the single-task learners and the custom modules (B4, K2/K3 and K4 at one "
          "system a launch; the general MAP step's B4)")
    single_launches, single_summaries = phase10(args.profile)
    for name, count in single_launches.items():
        launches[name] = launches.get(name, 0) + count
    for name, summary in single_summaries.items():
        print(f"slice {name}: " + json.dumps({"card": card, **summary}))

    print("phase 11: MAML and the Neural Process on sin_20, the image NP (no hand-written "
          "kernel)")
    t0 = time.perf_counter()
    for name, summary in phase11(args.profile).items():
        print(f"slice {name}: " + json.dumps({"card": card, **summary}))
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")
    print("phase 12: stacked fits (seed-parallel cauchy_20 and sin_32, hyper-parallel "
          "trials and tune_run on sin_20; K1 on a seed axis)")
    t0 = time.perf_counter()
    launches["svgd_phi seeds [5, 10, 2372]"], seed_summary = phase12a(args.profile)
    print("slice seed_cauchy_20: " + json.dumps({"card": card, **seed_summary}))
    print("slice seed_map_sin_32: " + json.dumps({"card": card, **phase12b()}))
    launches["svgd_phi trials [4, 10, 2308]"], trial_summary = phase12c()
    print("slice trials_sin_20: " + json.dumps({"card": card, **trial_summary}))
    print(f"phase 12: {time.perf_counter() - t0:.1f} s")
    print("phase 13: the multi-device layer on a one-rank NCCL mesh (the distributed tier "
          "through K4; the mesh'd general steps through K1-K3 and B4; the fan-out)")
    t0 = time.perf_counter()
    mesh_launches, mesh_summary = phase13()
    for name, count in mesh_launches.items():
        launches[name] = launches.get(name, 0) + count
    print("slice mesh: " + json.dumps({"card": card, **mesh_summary}))
    print(f"phase 13: {time.perf_counter() - t0:.1f} s")
    print("phase 14: the experiment CLIs and the demo through their main(argv) (per-algorithm "
          "runs, baseline comparison, meta-overfitting sweep, hyperparameter search, image NP)")
    t0 = time.perf_counter()
    cli_summary = phase14((map_summary["ll"], map_summary["rmse"], map_summary["calib"]))
    print("slice experiments: " + json.dumps({"card": card, **cli_summary}))
    print(f"phase 14: {time.perf_counter() - t0:.1f} s")
    print("phase 15: many tasks through the learners' entry points (sin_160 and sin_320 "
          "SVGD and VI fits through B2 and B7, an MLAP fit on sin_160 and the MLAP CLI's "
          "200-task eval through B8)")
    t0 = time.perf_counter()
    many_launches, many_summary = phase15()
    for name, count in many_launches.items():
        launches[name] = launches.get(name, 0) + count
    print("slice many tasks: " + json.dumps({"card": card, **many_summary}))
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")
    print("phase 16: the computational comparison through its main(argv) at its defaults "
          "(B6, B2, B7, B8 in fit and meta-test mode), beside its general-step twin")
    t0 = time.perf_counter()
    compare_launches, compare_summary = phase16()
    for name, count in compare_launches.items():
        launches[name] = launches.get(name, 0) + count
    print("slice computational_comparison: " + json.dumps({"card": card, **compare_summary}))
    print(f"phase 16: {time.perf_counter() - t0:.1f} s")
    print(f"all phases: {time.perf_counter() - t_start:.1f} s")
    print("the plain versions and library calls that read back to the host, by torch.profiler:")
    settle_kernel_sums(times, library)
    report_one_system()
    print("slice one system a launch: " + json.dumps({"card": card, **ONE_SYSTEM}))

    records = []
    rows = {**KERNELS, **{name: KERNELS["svgd_phi"] for name in K1_SEED_ROWS}}
    for name, (src, tpu) in rows.items():
        flops, n_bytes = work[name]
        t_ops, t_bytes = flops / PEAK_FLOPS, n_bytes / PEAK_BYTES
        records.append({"name": name, "route": "cuda", "source": src, "replaces": tpu,
                        "launches": launches[name], "max_abs_err": errs[name],
                        "ms": times[name][0], "plain_ms": times[name][1],
                        "bound_ms": 1e3 * max(t_ops, t_bytes),
                        "bound_by": "operations" if t_ops > t_bytes else "bytes",
                        "library_ms": library.get(name),
                        # "queued", "kernel sum": device time (settle_kernel_sums);
                        # "one call": one synchronised call, host time included
                        "timed_as": "queued" if f"{name} plain" in TIMED_AS else "one call",
                        "plain_timed_as": TIMED_AS.get(f"{name} plain", "one call"),
                        "library_timed_as": TIMED_AS.get(f"{name} library")})
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
