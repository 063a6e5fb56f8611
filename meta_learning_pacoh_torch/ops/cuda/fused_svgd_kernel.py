"""Fused PACOH-SVGD training kernel (csrc/fused_svgd.cu), its plain version, and its host-side trainer.

Replaces meta_learning_pacoh_tpu/ops/pallas/fused_train_kernel.py
(``fused_svgd_train_packed``, the Pallas kernel of ``_make_kernel``, and
``FusedSVGDTrainer``). One launch runs ``n_steps`` PACOH-SVGD iterations of
K particles: the score of the masked GP marginal likelihood plus the
hyper-prior, the RBF Stein transport with the median at rank K*K//2, and an
Adam step equal to ``optax.adam`` with its float32 bias corrections.

The state stays in the canonical flat ``[K, P]`` layout of ``HyperPrior``
(the JAX package's ``ravel_pytree`` order), whose ``slice_of`` gives the
kernel each leaf's offset. The TPU kernel's packed layouts (cat rows,
block-diagonal hidden weights, iota helper matrices) existed to fill TPU
lanes and are not ported, so the learner's particles and Adam moments are
updated in place and need no conversion afterwards.

The kernel runs one thread-block cluster of C CTAs a particle
(``cluster_plan`` chooses C, the activations' row stride, the staging chunk
and the tasks a tile; ``smem_bytes`` mirrors a CTA's shared memory). A CTA
whose tasks' rows do not fit beside the rest walks them in tiles, so the
task count is bounded only by device memory. The window of the kernel
(``fused_svgd_fits``): NN mean and NN kernel with feature_dim 1 and one
hidden width, 1 <= K <= 32 particles, tasks of N <= 8 points, and a CTA of
one task's rows within one block's shared memory; it does not depend on T,
as the JAX learners' gate does not, and ``cluster_plan`` finds a plan for
every T.
"""

import dataclasses
import functools

import numpy as np
import torch

from meta_learning_pacoh_torch.models.gp_base import gp_prior_mll_batch
from meta_learning_pacoh_torch.models.random_gp import (
    make_hyper_prior,
    meta_log_prob,
    random_gp_config,
)
from meta_learning_pacoh_torch.ops import cuda
from meta_learning_pacoh_torch.ops.cuda.build import launch
from meta_learning_pacoh_torch.ops.cuda.svgd_kernel import svgd_phi_ref
from meta_learning_pacoh_torch.ops.launch_sched import (
    count_pages,
    staircase_launches,
    staircase_lr,
)
from meta_learning_pacoh_torch.utils.profiling import (
    TRAINER_BUILD,
    TRAINER_LAUNCH,
    TRAINER_PAGES,
    span,
    spanned,
)

MAX_K = 32  # the transport keeps the K x K distances in shared memory
MAX_N = 8  # the per-task factorization is unrolled in registers
SMEM_BYTES = 232448  # shared memory one Hopper block can use
# Cluster sizes in the order the plan tries them, fastest first at sin_20
# (tools/fused_step_bench.py on the H100).
CLUSTER_SIZES = (8, 5, 4, 2, 1)
# Clusters of C CTAs resident at once on an H100 SXM (132 SMs) at one CTA an
# SM, cudaOccupancyMaxActiveClusters (chip_smoke.py prints the card's own
# beside the plan's).
RESIDENT_CLUSTERS = {1: 132, 2: 66, 4: 30, 5: 22, 8: 15}


@functools.lru_cache(maxsize=None)
def fused_prior(d, hidden, wps, bps):
    """The hyper-prior of the kernel's configuration: NN/NN, feature_dim 1."""
    cfg = random_gp_config(d, feature_dim=1, mean_nn_layers=hidden, kernel_nn_layers=hidden)
    return make_hyper_prior(cfg, weight_prior_std=wps, bias_prior_std=bps)


def leaf_offsets(hyper_prior, n_layers):
    """Flat offsets in the kernel's order: per net (mean, kernel) w_l, b_l of
    every hidden layer, then w_out, b_out; then lengthscale_raw, noise_raw."""
    offs = []
    for net in ("mean_nn", "kernel_nn"):
        for name in [f"{kind}_{i}" for i in range(n_layers) for kind in ("w", "b")]:
            offs.append(hyper_prior.slice_of((net, name)).start)
        offs += [hyper_prior.slice_of((net, "w_out")).start,
                 hyper_prior.slice_of((net, "b_out")).start]
    offs += [hyper_prior.slice_of(("lengthscale_raw",)).start,
             hyper_prior.slice_of(("noise_raw",)).start]
    return offs


@functools.lru_cache(maxsize=None)
def _prior_on(d, hidden, wps, bps, device):
    hp = fused_prior(d, hidden, wps, bps)
    return dataclasses.replace(hp, loc=hp.loc.to(device), scale=hp.scale.to(device))


@functools.lru_cache(maxsize=None)
def _device_operands(d, hidden, wps, bps, device):
    hp = _prior_on(d, hidden, wps, bps, device)
    offs = torch.tensor(leaf_offsets(hp, len(hidden)), dtype=torch.int32)
    return hp.loc, hp.scale, offs.to(device)


def fused_svgd_fits(k, t, n, d, hidden):
    """Whether the kernel takes this configuration: the structural window
    and a plan at one task, which every task count then has (one task a
    tile)."""
    del t  # a shape that fits at one task fits at every T
    hidden = tuple(int(h) for h in hidden)
    return (1 <= k <= MAX_K and 1 <= n <= MAX_N and len(hidden) >= 1
            and len(set(hidden)) == 1 and _plan(k, 1, n, d, hidden, None) is not None)


def task_lo(r, t, c):
    """First task of CTA r of a cluster of c over t tasks: CTA r owns
    [task_lo(r), task_lo(r + 1)) (csrc/cluster_score.cuh)."""
    return r * t // c


def slice_len(p, c):
    """Floats of each CTA's slice of P: CTA r owns [r * slice_len,
    min(p, (r + 1) * slice_len)) (csrc/cluster_score.cuh)."""
    return (-(-p // c) + 3) // 4 * 4


def stash_pitch(ch):
    """Row pitch of the staging for chunks of ch coordinates
    (csrc/fused_svgd.cu): 4 mod 32 for 16-byte rows, odd otherwise."""
    return ch + (36 - ch % 32) % 32 if ch % 4 == 0 else ch | 1


def smem_bytes(k, t, n, d, hidden, p, c, hs, ch, tile=None):
    """Shared memory of one CTA, as csrc/fused_svgd.cu lays it out: the
    staging of K particles' and scores' chunks of ch coordinates, the
    particle and the CTA's partial score, its rows' activation slots (row
    stride hs), its rows and tasks (a tile's, at most ``tile`` tasks), the
    pair distances, their pairs and segment sums, the kernel row, the leaf
    offsets."""
    tmax = -(-t // c) if tile is None else min(-(-t // c), tile)
    rmax = tmax * n
    pairs = k * (k - 1) // 2
    return 4 * (2 * p + (len(hidden) + 1) * 2 * rmax * hs + rmax * (d + 4) + 2 * tmax
                + 2 * k * stash_pitch(ch) + 3 * pairs + max(pairs, 512) + k + 8 + 4 * len(hidden)
                + 6)


def _staging(k, t, n, d, hidden, p, c, hs, tile):
    """The staging chunk that fits beside the rest of a CTA of tiles of
    ``tile`` tasks (a whole slice where it fits, a multiple of 4 floats
    where it can be), or None."""
    rest = smem_bytes(k, t, n, d, hidden, p, c, hs, 0, tile) - 8 * k * stash_pitch(0)
    room = (SMEM_BYTES - rest) // (8 * k)
    sl = slice_len(p, c)
    if stash_pitch(sl) <= room:
        return sl
    if room >= 32:
        return (room - 28) // 4 * 4
    if room >= 1:  # an odd chunk, its own pitch
        return room - 1 + room % 2
    return None


def largest_tile(fits_bytes, tmax):
    """The most tasks a tile below tmax whose CTA fits (``fits_bytes(tile)``
    is a CTA's bytes, linear in the tile), or None where one task does not."""
    base, per = fits_bytes(0), fits_bytes(1) - fits_bytes(0)
    if tmax < 2 or base + per > SMEM_BYTES:
        return None
    return min(tmax - 1, (SMEM_BYTES - base) // per)


@functools.lru_cache(maxsize=None)
def _plan(k, t, n, d, hidden, cluster):
    p = fused_prior(d, hidden, 1.0, 1.0).dim
    h = hidden[0]
    sizes = [c for c in CLUSTER_SIZES if c <= t and k <= RESIDENT_CLUSTERS[c]]
    sizes = sizes if cluster is None else [int(cluster)]
    for c in sizes:  # every task's rows held whole, as the window's shapes always are
        for hs in dict.fromkeys((h | 1, h)):
            ch = _staging(k, t, n, d, hidden, p, c, hs, None)
            if ch is not None:
                return c, hs, ch, -(-t // c)
    for c in sizes:  # tiles: a whole slice staged, then the most tasks a tile
        for hs in dict.fromkeys((h | 1, h)):
            sl = slice_len(p, c)
            tile = largest_tile(
                lambda tt: smem_bytes(k, t, n, d, hidden, p, c, hs, sl, tt), -(-t // c))
            if tile is not None:
                return c, hs, sl, tile
            ch = _staging(k, t, n, d, hidden, p, c, hs, 1)
            if ch is not None and -(-t // c) > 1:
                return c, hs, ch, 1
    return None


def cluster_plan(k, t, n, d, hidden, cluster=None):
    """(C, hs, ch, tile) of a launch: the first size of ``CLUSTER_SIZES``
    with no more CTAs than tasks whose K clusters ``RESIDENT_CLUSTERS``
    holds at once and whose CTA fits in shared memory with its tasks' rows
    whole (tile = ceil(T / C)), an odd activation row stride where it fits
    (H otherwise), and the staging chunk ch (a whole slice where it fits, a
    multiple of 4 floats where it can be); where no such CTA fits, the first
    size whose CTA fits with a whole slice staged and the most tasks a tile,
    or one task a tile beside a shorter chunk. ``cluster`` forces C (the
    learners never pass it)."""
    hidden = tuple(int(h) for h in hidden)
    plan = _plan(k, t, n, d, hidden, None if cluster is None else int(cluster))
    if plan is None:
        raise ValueError(f"fused_svgd: no cluster plan for K={k}, T={t}, N={n}, D={d}, "
                         f"hidden={hidden}, cluster={cluster}")
    return plan


def resident_clusters(k, t, n, d, hidden, plan, device="cuda"):
    """Clusters of the plan's C CTAs resident at once on the card
    (cudaOccupancyMaxActiveClusters, read by the kernel's C entry)."""
    import ctypes

    hidden = tuple(int(h) for h in hidden)
    c, hs, ch, tile = plan
    p = fused_prior(d, hidden, 1.0, 1.0).dim
    out = ctypes.c_int(0)
    launch("pacoh_fused_svgd_clusters", torch.empty(0, device=device), k, t, n, d, hidden[0],
           len(hidden), p, c, hs, ch, tile, ctypes.addressof(out))
    return out.value


def task_weights(mask, task_batch_size=None):
    """Per-task MLL weight pre / n_eff_t (0 for an empty task), as float32.

    pre = m~ / (m~ + batch) with m~ the harmonic-mean task size; a sampled
    batch (task_batch_size < T) needs uniform task sizes, so that its m~ is
    one constant for every draw.
    """
    sizes = np.asarray(mask, np.float32).sum(axis=-1)
    n_tasks = sizes.shape[0]
    if task_batch_size is not None and int(task_batch_size) != n_tasks:
        if not np.all(sizes == sizes[0]):
            raise ValueError("sampled task batches need uniform task sizes")
        harmonic, batch_n = float(sizes[0]), int(task_batch_size)
    else:
        harmonic, batch_n = 1.0 / np.mean(1.0 / sizes), n_tasks
    pre = float(harmonic / (harmonic + batch_n))
    return np.where(sizes > 0, pre / np.maximum(sizes, 1.0), 0.0).astype(np.float32)


def fused_svgd_train_ref(theta, mu, nu, x, y, mask, w_t, step0, lr, prior_factor, counts=None,
                         *, hidden, wps, bps, n_steps, task_mll=gp_prior_mll_batch):
    """Plain PyTorch version of ``fused_svgd_train``, updating in place.

    Each step: the score by autograd of ``meta_log_prob`` (count-weighted
    with ``counts[i]`` when given, its task MLLs from ``task_mll``),
    ``svgd_phi_ref``, and the optax Adam update of
    fused_train_kernel.py:688-707. ``w_t`` must be the weights that
    ``meta_log_prob`` applies, ``task_weights(mask, batch)``.
    """
    hidden = tuple(int(h) for h in hidden)
    hp = _prior_on(x.shape[-1], hidden, float(wps), float(bps), theta.device)
    batch = None if counts is None else int(round(float(counts[0].sum())))
    want_w = torch.from_numpy(task_weights(mask.cpu().numpy(), batch)).to(w_t.device)
    if not torch.allclose(w_t, want_w, rtol=1e-6, atol=0.0):
        raise ValueError("fused_svgd: w_t differs from task_weights(mask)")
    for i in range(n_steps):
        p = theta.detach().requires_grad_(True)
        lp = meta_log_prob(hp, prior_factor, p, x, y, mask,
                           counts=None if counts is None else counts[i], task_mll=task_mll)
        (score,) = torch.autograd.grad(lp.sum(), p)
        with torch.no_grad():
            cuda.adam_step_(theta, mu, nu, -svgd_phi_ref(theta, score), step0 + i + 1, lr)
    return theta, mu, nu


def fused_svgd_train(theta, mu, nu, x, y, mask, w_t, step0, lr, prior_factor, counts=None,
                     *, hidden, wps, bps, n_steps, cluster=None):
    """n_steps of PACOH-SVGD on flat particles theta [K, P] and Adam moments
    mu, nu [K, P], all updated in place.

    x [T, N, D], y [T, N], mask [T, N]; w_t [T] = ``task_weights(mask, ...)``;
    step0 the global step of the first step (its bias corrections); lr the
    launch's learning rate; counts [n_steps, T] the per-step task-draw counts
    of a sampled batch, or None for the full batch; ``cluster`` forces the
    cluster size C (``cluster_plan``). The plain version for CPU tensors,
    the kernel for CUDA tensors.
    """
    hidden = tuple(int(h) for h in hidden)
    if theta.device.type == "cpu":
        return fused_svgd_train_ref(theta, mu, nu, x, y, mask, w_t, step0, lr, prior_factor,
                                    counts, hidden=hidden, wps=wps, bps=bps, n_steps=n_steps)
    operands = [("theta", theta, 2), ("mu", mu, 2), ("nu", nu, 2), ("x", x, 3), ("y", y, 2),
                ("mask", mask, 2), ("w_t", w_t, 1)]
    if counts is not None:
        operands.append(("counts", counts, 2))
    for name, t_, ndim in operands:
        cuda.check_operand(f"fused_svgd {name}", t_, ndim)
        if t_.device != theta.device:
            raise ValueError(f"fused_svgd {name}: on {t_.device}, theta on {theta.device}")
    k, p = theta.shape
    t, n, d = x.shape
    if not fused_svgd_fits(k, t, n, d, hidden):
        raise ValueError(f"fused_svgd: the kernel does not take K={k}, T={t}, N={n}, D={d}, "
                         f"hidden={hidden}")
    p_want = fused_prior(d, hidden, 1.0, 1.0).dim
    if (p != p_want or mu.shape != theta.shape or nu.shape != theta.shape
            or y.shape != (t, n) or mask.shape != (t, n) or w_t.shape != (t,)
            or (counts is not None and counts.shape != (n_steps, t))):
        raise ValueError("fused_svgd: operand shapes do not match theta [K, P] and x [T, N, D]")
    if n_steps < 1:
        return theta, mu, nu
    c, hs, ch, tile = cluster_plan(k, t, n, d, hidden, cluster)
    loc, scale, offs = _device_operands(d, hidden, float(wps), float(bps), theta.device)
    th_buf = torch.empty(2, k, p, dtype=theta.dtype, device=theta.device)
    s_buf = torch.empty_like(th_buf)
    launch("pacoh_fused_svgd", theta, theta.data_ptr(), mu.data_ptr(), nu.data_ptr(),
           x.data_ptr(), y.data_ptr(), mask.data_ptr(), w_t.data_ptr(),
           None if counts is None else counts.data_ptr(), loc.data_ptr(), scale.data_ptr(),
           offs.data_ptr(), th_buf.data_ptr(), s_buf.data_ptr(),
           k, t, n, d, hidden[0], len(hidden), p, int(n_steps), c, hs, ch, tile, float(step0),
           float(lr), float(prior_factor))
    cuda.LAUNCHES["fused_svgd"] += 1
    return theta, mu, nu


class FusedSVGDTrainer:
    """Host-side trainer of the fused kernel over a learner's flat state.

    It folds the per-task weights once, splits a run into launches that
    cross no staircase boundary of the lr schedule, and in the sampled-batch
    mode (task_batch_size < T) builds each launch's count pages from
    ``task_draw(step)``, the learner's own task indices of a global step, so
    the fused and the general step follow one random trajectory. The state
    is the caller's tensors, updated in place: there is nothing to sync.
    """

    MAX_LAUNCH = 512  # steps a launch in the sampled mode (bounds its count pages)
    train_fn = staticmethod(fused_svgd_train)  # the kernel a launch runs

    @spanned(TRAINER_BUILD)
    def __init__(self, X, Y, mask, *, hidden, lr, prior_factor, weight_prior_std,
                 bias_prior_std, lr_decay=1.0, task_batch_size=None, task_draw=None):
        self.X, self.Y, self.mask = X, Y, mask
        self.n_tasks = int(X.shape[0])
        self.hidden = tuple(int(h) for h in hidden)
        self.lr, self.lr_decay = float(lr), float(lr_decay)
        self.prior_factor = float(prior_factor)
        self.wps, self.bps = float(weight_prior_std), float(bias_prior_std)
        self.counted = task_batch_size is not None and int(task_batch_size) != self.n_tasks
        if self.counted and task_draw is None:
            raise ValueError("a sampled task batch needs task_draw")
        self.task_draw = task_draw
        self.w_t = torch.from_numpy(task_weights(mask.cpu().numpy(), task_batch_size)).to(
            X.device)

    @spanned(TRAINER_PAGES)
    def count_pages(self, step0, n_steps):
        """[n_steps, T] draw counts of global steps step0 .. step0 + n_steps - 1."""
        return count_pages(self.task_draw, self.n_tasks, step0, n_steps).to(self.X.device)

    def launches(self, step0, n_steps):
        """(launch_step0, sub_steps) of a run of n_steps from global step step0."""
        cap = self.MAX_LAUNCH if self.counted else int(n_steps)
        return staircase_launches(step0, n_steps, cap, self.lr_decay)

    def launch(self, theta, mu, nu, step0, n_steps):
        counts = self.count_pages(step0, n_steps) if self.counted else None
        with span(TRAINER_LAUNCH):
            self.train_fn(theta, mu, nu, self.X, self.Y, self.mask, self.w_t, step0,
                          staircase_lr(self.lr, self.lr_decay, step0), self.prior_factor,
                          counts, hidden=self.hidden, wps=self.wps, bps=self.bps,
                          n_steps=n_steps)

    def run(self, theta, mu, nu, n_steps, step0):
        for s, sub in self.launches(step0, n_steps):
            self.launch(theta, mu, nu, s, sub)
