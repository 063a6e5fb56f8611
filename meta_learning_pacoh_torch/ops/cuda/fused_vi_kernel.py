"""Fused PACOH-VI training kernel (csrc/fused_vi.cu), its plain version, and its host-side trainer.

Replaces meta_learning_pacoh_tpu/ops/pallas/fused_vi_kernel.py
(``fused_vi_train_packed``, the Pallas kernel of ``_make_vi_kernel``, and
``FusedVITrainer``). One launch runs ``n_steps`` PACOH-VI iterations of the
diagonal Gaussian hyper-posterior (loc, log_scale): S reparameterised
samples from the step's noise page, their particle scores (the score
section shared with the fused SVGD kernel), the closed-form gradients of the
negative ELBO, and an Adam step equal to ``optax.adam`` with its float32
bias corrections on loc and log_scale.

The state is the learner's flat ``[P]`` loc, log_scale and their Adam
moments in the JAX package's ``ravel_pytree`` order, updated in place. The
TPU kernel's ``pack_state``, ``eps_layout`` and ``pack_eps_page`` existed to
fill TPU lanes and are not ported: a noise page is the step's ``[S, P]``
standard normals as they are.

The kernel runs one thread-block cluster of C CTAs a sample
(``cluster_plan`` chooses C, the activations' row stride and the tasks a
tile; ``smem_bytes`` mirrors a CTA's shared memory). A CTA whose tasks'
rows do not fit beside the rest walks them in tiles, so the task count is
bounded only by device memory. The window of the kernel (``fused_vi_fits``):
NN mean and NN kernel with feature_dim 1 and one hidden width, 1 <= S <= 32
samples, tasks of N <= 8 points, and a CTA of one task's rows within one
block's shared memory; it does not depend on T, as the JAX learners' gate
does not, and ``cluster_plan`` finds a plan for every T.
"""

import functools
import math

import numpy as np
import torch

from meta_learning_pacoh_torch.models.gp_base import gp_prior_mll_batch
from meta_learning_pacoh_torch.models.random_gp import neg_elbo
from meta_learning_pacoh_torch.ops import cuda
from meta_learning_pacoh_torch.ops.cuda.build import launch
from meta_learning_pacoh_torch.ops.cuda.fused_svgd_kernel import (
    CLUSTER_SIZES,
    RESIDENT_CLUSTERS,
    _device_operands,
    _prior_on,
    fused_prior,
    largest_tile,
    slice_len,
    task_weights,
)
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

MAX_S = 32  # samples, one block each
MAX_N = 8  # the per-task factorization is unrolled in registers
SMEM_BYTES = 232448  # shared memory one Hopper block can use
_LOG_2PI = math.log(2.0 * math.pi)


def smem_bytes(t, n, d, hidden, p, c, hs, tile=None):
    """Shared memory of one CTA, as csrc/fused_vi.cu lays it out: the sample
    and the CTA's partial score, its rows' activation slots (row stride hs),
    its rows and tasks (a tile's, at most ``tile`` tasks), its slice of the
    posterior and of both pairs of Adam moments, the leaf offsets."""
    tmax = -(-t // c) if tile is None else min(-(-t // c), tile)
    rmax = tmax * n
    return 4 * (2 * p + (len(hidden) + 1) * 2 * rmax * hs + rmax * (d + 4) + 3 * tmax
                + 6 * slice_len(p, c) + 32 + 8 + 4 * len(hidden) + 6)


@functools.lru_cache(maxsize=None)
def _plan(s, t, n, d, hidden, cluster):
    p = fused_prior(d, hidden, 1.0, 1.0).dim
    h = hidden[0]
    sizes = [c for c in CLUSTER_SIZES if c <= t and s <= RESIDENT_CLUSTERS[c]]
    sizes = sizes if cluster is None else [int(cluster)]
    for c in sizes:  # every task's rows held whole, as the window's shapes always are
        for hs in dict.fromkeys((h | 1, h)):
            if smem_bytes(t, n, d, hidden, p, c, hs) <= SMEM_BYTES:
                return c, hs, -(-t // c)
    for c in sizes:  # tiles of the most tasks that fit
        for hs in dict.fromkeys((h | 1, h)):
            tile = largest_tile(lambda tt: smem_bytes(t, n, d, hidden, p, c, hs, tt), -(-t // c))
            if tile is not None:
                return c, hs, tile
    return None


def cluster_plan(s, t, n, d, hidden, cluster=None):
    """(C, hs, tile) of a launch: the first size of ``CLUSTER_SIZES`` with
    no more CTAs than tasks whose S clusters ``RESIDENT_CLUSTERS`` holds at
    once and whose CTA fits in shared memory with its tasks' rows whole
    (tile = ceil(T / C)), with an odd activation row stride where it fits
    (H otherwise); where no such CTA fits, the first size whose CTA fits
    with the most tasks a tile. ``cluster`` forces C (the learners never
    pass it)."""
    hidden = tuple(int(h) for h in hidden)
    plan = _plan(s, t, n, d, hidden, None if cluster is None else int(cluster))
    if plan is None:
        raise ValueError(f"fused_vi: no cluster plan for S={s}, T={t}, N={n}, D={d}, "
                         f"hidden={hidden}, cluster={cluster}")
    return plan


def resident_clusters(t, n, d, hidden, plan, device="cuda"):
    """Clusters of the plan's C CTAs resident at once on the card
    (cudaOccupancyMaxActiveClusters, read by the kernel's C entry)."""
    import ctypes

    hidden = tuple(int(h) for h in hidden)
    c, hs, tile = plan
    p = fused_prior(d, hidden, 1.0, 1.0).dim
    out = ctypes.c_int(0)
    launch("pacoh_fused_vi_clusters", torch.empty(0, device=device), t, n, d, hidden[0],
           len(hidden), p, c, hs, tile, ctypes.addressof(out))
    return out.value


def fused_vi_fits(s, t, n, d, hidden):
    """Whether the kernel takes this configuration: the structural window
    and a plan at one task, which every task count then has (one task a
    tile)."""
    del t  # a shape that fits at one task fits at every T
    hidden = tuple(int(h) for h in hidden)
    return (1 <= s <= MAX_S and 1 <= n <= MAX_N and len(hidden) >= 1
            and len(set(hidden)) == 1 and _plan(s, 1, n, d, hidden, None) is not None)


def mll_constant(mask, task_batch_size=None):
    """The static part of the weighted MLL sum, sum_t w_t n_t log(2 pi): pre *
    batch * log(2 pi) for a sampled batch (uniform task sizes), pre times the
    number of non-empty tasks times log(2 pi) for the full batch; a Python
    float, rounded to float32 once where the kernel takes it."""
    sizes = np.asarray(mask, np.float32).sum(axis=-1)
    n_tasks = sizes.shape[0]
    if task_batch_size is not None and int(task_batch_size) != n_tasks:
        harmonic, batch_n = float(sizes[0]), int(task_batch_size)
        return float(harmonic / (harmonic + batch_n) * batch_n * _LOG_2PI)
    harmonic = 1.0 / np.mean(1.0 / sizes)
    pre = float(harmonic / (harmonic + n_tasks))
    return float(np.sum((sizes > 0) * pre) * _LOG_2PI)


def prior_constants(d, hidden, wps, bps):
    """(lp_const, ent_const): the static parts of the hyper-prior's log
    density, -(n_w log wps + n_b log bps) - P/2 log(2 pi) (the lengthscale,
    noise and their unit scales add 0), and of the posterior's entropy,
    P/2 (1 + log(2 pi)); Python floats, as the JAX trainer forms them."""
    hidden = tuple(hidden)
    sizes = (d,) + hidden + (1,)
    n_w = 2 * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    n_b = 2 * (sum(hidden) + 1)
    p = fused_prior(d, hidden, 1.0, 1.0).dim
    lp_const = float(-(n_w * math.log(wps) + n_b * math.log(bps)) - 0.5 * p * _LOG_2PI)
    return lp_const, float(0.5 * p * (1.0 + _LOG_2PI))


def _check_weights(w_t, mll_const, mask, counts):
    batch = None if counts is None else int(round(float(counts[0].sum())))
    want_w = torch.from_numpy(task_weights(mask.cpu().numpy(), batch)).to(w_t.device)
    if not torch.allclose(w_t, want_w, rtol=1e-6, atol=0.0):
        raise ValueError("fused_vi: w_t differs from task_weights(mask)")
    want_c = mll_constant(mask.cpu().numpy(), batch)
    if not math.isclose(float(mll_const), want_c, rel_tol=1e-6, abs_tol=1e-6):
        raise ValueError("fused_vi: mll_const differs from mll_constant(mask)")


def fused_vi_train_ref(loc, lsc, m_loc, m_lsc, v_loc, v_lsc, x, y, mask, w_t, eps, step0, lr,
                       prior_factor, counts=None, *, hidden, wps, bps, mll_const, n_steps,
                       task_mll=gp_prior_mll_batch):
    """Plain PyTorch version of ``fused_vi_train``, updating in place.

    Each step: the negative ELBO of the samples loc + exp(lsc) * eps[i]
    (``neg_elbo``, count-weighted with ``counts[i]`` when given, its task
    MLLs from ``task_mll``), its
    gradients by autograd, and the optax Adam update of
    fused_vi_kernel.py:320-332 on loc and lsc with one step count. ``w_t`` and
    ``mll_const`` must be ``task_weights`` and ``mll_constant`` of the mask
    (the kernel's loss uses them; here they are only checked).
    """
    hidden = tuple(int(h) for h in hidden)
    _check_weights(w_t, mll_const, mask, counts)
    hp = _prior_on(x.shape[-1], hidden, float(wps), float(bps), loc.device)
    losses = []
    for i in range(n_steps):
        post = {"loc": loc.detach().requires_grad_(True),
                "log_scale": lsc.detach().requires_grad_(True)}
        loss = neg_elbo(hp, prior_factor, post, eps[i], x, y, mask,
                        counts=None if counts is None else counts[i], task_mll=task_mll)
        g_loc, g_lsc = torch.autograd.grad(loss, (post["loc"], post["log_scale"]))
        with torch.no_grad():
            cuda.adam_step_(loc, m_loc, v_loc, g_loc, step0 + i + 1, lr)
            cuda.adam_step_(lsc, m_lsc, v_lsc, g_lsc, step0 + i + 1, lr)
        losses.append(loss.detach())
    return losses[-1], torch.mean(torch.stack(losses))


def fused_vi_train(loc, lsc, m_loc, m_lsc, v_loc, v_lsc, x, y, mask, w_t, eps, step0, lr,
                   prior_factor, counts=None, *, hidden, wps, bps, mll_const, n_steps,
                   cluster=None):
    """n_steps of PACOH-VI on the flat posterior loc, lsc (log_scale) [P] and
    their Adam moments m_loc, m_lsc, v_loc, v_lsc [P], all updated in place.
    Returns (last loss, mean loss) of the steps as device scalars.

    x [T, N, D], y [T, N], mask [T, N]; w_t [T] = ``task_weights(mask, ...)``;
    eps [n_steps, S, P] the steps' standard normals; step0 the global step of
    the first step (its bias corrections); lr the launch's learning rate;
    counts [n_steps, T] the per-step task-draw counts of a sampled batch, or
    None for the full batch; mll_const = ``mll_constant(mask, ...)``;
    ``cluster`` forces the cluster size C (``cluster_plan``). The plain
    version for CPU tensors, the kernel for CUDA tensors.
    """
    hidden = tuple(int(h) for h in hidden)
    if n_steps < 1:
        raise ValueError(f"fused_vi: n_steps must be >= 1, got {n_steps}")
    if loc.device.type == "cpu":
        return fused_vi_train_ref(loc, lsc, m_loc, m_lsc, v_loc, v_lsc, x, y, mask, w_t, eps,
                                  step0, lr, prior_factor, counts, hidden=hidden, wps=wps,
                                  bps=bps, mll_const=mll_const, n_steps=n_steps)
    state = (("loc", loc), ("lsc", lsc), ("m_loc", m_loc), ("m_lsc", m_lsc), ("v_loc", v_loc),
             ("v_lsc", v_lsc))
    operands = [(name, t_, 1) for name, t_ in state]
    operands += [("x", x, 3), ("y", y, 2), ("mask", mask, 2), ("w_t", w_t, 1), ("eps", eps, 3)]
    if counts is not None:
        operands.append(("counts", counts, 2))
    for name, t_, ndim in operands:
        cuda.check_operand(f"fused_vi {name}", t_, ndim)
        if t_.device != loc.device:
            raise ValueError(f"fused_vi {name}: on {t_.device}, loc on {loc.device}")
    s, p = eps.shape[1], eps.shape[2]
    t, n, d = x.shape
    if not fused_vi_fits(s, t, n, d, hidden):
        raise ValueError(f"fused_vi: the kernel does not take S={s}, T={t}, N={n}, D={d}, "
                         f"hidden={hidden}")
    if (p != fused_prior(d, hidden, 1.0, 1.0).dim or any(a.shape != (p,) for _, a in state)
            or eps.shape[0] != n_steps or y.shape != (t, n) or mask.shape != (t, n)
            or w_t.shape != (t,) or (counts is not None and counts.shape != (n_steps, t))):
        raise ValueError("fused_vi: operand shapes do not match loc [P], eps [n_steps, S, P] "
                         "and x [T, N, D]")
    c, hs, tile = cluster_plan(s, t, n, d, hidden, cluster)
    prior_loc, prior_scale, offs = _device_operands(d, hidden, float(wps), float(bps), loc.device)
    lp_const, ent_const = prior_constants(d, hidden, float(wps), float(bps))
    s_buf = torch.empty(2, s, p, dtype=loc.dtype, device=loc.device)
    o_buf = torch.empty(2, s, c, 2, dtype=loc.dtype, device=loc.device)
    loss = torch.empty(2, dtype=loc.dtype, device=loc.device)
    launch("pacoh_fused_vi", loc, *(a.data_ptr() for _, a in state), x.data_ptr(),
           y.data_ptr(), mask.data_ptr(), w_t.data_ptr(),
           None if counts is None else counts.data_ptr(), eps.data_ptr(), prior_loc.data_ptr(),
           prior_scale.data_ptr(), offs.data_ptr(), s_buf.data_ptr(), o_buf.data_ptr(),
           loss.data_ptr(), s, t, n, d, hidden[0], len(hidden), p, int(n_steps), c, hs, tile,
           float(step0), float(lr), float(prior_factor), float(mll_const), lp_const, ent_const)
    cuda.LAUNCHES["fused_vi"] += 1
    return loss[0], loss[1] / n_steps


class FusedVITrainer:
    """Host-side trainer of the fused kernel over a learner's flat state.

    It folds the per-task weights and the MLL constant once, splits a run
    into launches of at most ``MAX_LAUNCH`` steps that cross no staircase
    boundary of the lr schedule, and builds each launch's noise pages from
    ``eps_draw(step, out)`` (which fills ``out`` [S, P] with the learner's own
    noise of a global step) and, in the sampled-batch mode (task_batch_size
    < T), its count pages from ``task_draw(step)``, so the fused and the
    general step follow one random trajectory. The state is the caller's
    tensors, updated in place.
    """

    MAX_LAUNCH = 512  # steps a launch (bounds its noise pages: 47 MB at sin_20)
    train_fn = staticmethod(fused_vi_train)  # the kernel a launch runs

    @spanned(TRAINER_BUILD)
    def __init__(self, X, Y, mask, *, hidden, lr, prior_factor, weight_prior_std,
                 bias_prior_std, svi_batch_size, eps_draw, lr_decay=1.0, task_batch_size=None,
                 task_draw=None, cluster=None):
        self.X, self.Y, self.mask = X, Y, mask
        self.n_tasks = int(X.shape[0])
        self.hidden = tuple(int(h) for h in hidden)
        self.lr, self.lr_decay = float(lr), float(lr_decay)
        self.prior_factor = float(prior_factor)
        self.wps, self.bps = float(weight_prior_std), float(bias_prior_std)
        self.n_samples = int(svi_batch_size)
        self.p = fused_prior(int(X.shape[-1]), self.hidden, 1.0, 1.0).dim
        self.counted = task_batch_size is not None and int(task_batch_size) != self.n_tasks
        if self.counted and task_draw is None:
            raise ValueError("a sampled task batch needs task_draw")
        self.task_draw, self.eps_draw = task_draw, eps_draw
        mask_np = mask.cpu().numpy()
        self.w_t = torch.from_numpy(task_weights(mask_np, task_batch_size)).to(X.device)
        self.mll_const = mll_constant(mask_np, task_batch_size)
        self.last_loss = self.avg_loss = float("nan")
        self.cluster = cluster  # forces the kernel's cluster size; the learners never set it

    @spanned(TRAINER_PAGES)
    def count_pages(self, step0, n_steps):
        """[n_steps, T] draw counts of global steps step0 .. step0 + n_steps - 1."""
        return count_pages(self.task_draw, self.n_tasks, step0, n_steps).to(self.X.device)

    @spanned(TRAINER_PAGES)
    def eps_pages(self, step0, n_steps):
        """[n_steps, S, P] noise of global steps step0 .. step0 + n_steps - 1."""
        pages = torch.empty(n_steps, self.n_samples, self.p, dtype=torch.float32,
                            device=self.X.device)
        for i in range(n_steps):
            self.eps_draw(step0 + i, pages[i])
        return pages

    def launches(self, step0, n_steps):
        """(launch_step0, sub_steps) of a run of n_steps from global step step0."""
        return staircase_launches(step0, n_steps, self.MAX_LAUNCH, self.lr_decay)

    def launch(self, loc, lsc, m_loc, m_lsc, v_loc, v_lsc, step0, n_steps):
        counts = self.count_pages(step0, n_steps) if self.counted else None
        eps = self.eps_pages(step0, n_steps)
        forced = {} if self.cluster is None else {"cluster": self.cluster}
        with span(TRAINER_LAUNCH):
            return self.train_fn(loc, lsc, m_loc, m_lsc, v_loc, v_lsc, self.X, self.Y,
                                 self.mask, self.w_t, eps, step0,
                                 staircase_lr(self.lr, self.lr_decay, step0), self.prior_factor,
                                 counts, hidden=self.hidden, wps=self.wps, bps=self.bps,
                                 mll_const=self.mll_const, n_steps=n_steps, **forced)

    def run(self, loc, lsc, m_loc, m_lsc, v_loc, v_lsc, n_steps, step0):
        """n_steps from global step step0; (last loss, mean loss) as device
        scalars, also kept as ``last_loss`` and ``avg_loss``."""
        last, total = None, 0.0
        for s, sub in self.launches(step0, n_steps):
            last, mean = self.launch(loc, lsc, m_loc, m_lsc, v_loc, v_lsc, s, sub)
            total = total + mean * sub
        self.last_loss, self.avg_loss = last, total / n_steps
        return self.last_loss, self.avg_loss
