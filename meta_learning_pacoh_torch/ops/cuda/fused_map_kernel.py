"""Fused PACOH-MAP training kernel (csrc/fused_map.cu), its plain version, and its host-side trainer.

Replaces meta_learning_pacoh_tpu/ops/pallas/fused_map_kernel.py
(``fused_map_train_packed``, the Pallas kernel of ``_make_kernel``, and
``FusedMAPTrainer``). One launch runs ``n_steps`` PACOH-MAP iterations of one
GP prior (NN mean, NN-featurised RBF kernel with an outputscale, noise with
the 1e-3 floor): the loss -sum_t w_t MLL_t over all tasks, weighted by the
step's draw counts for a sampled batch, its gradient, and an AdamW step
equal to ``optax.adamw`` with the float32 bias corrections of the TPU kernel.

The state is the learner's flat ``[P]`` parameter vector and AdamW moments
in the JAX package's ``ravel_pytree`` order; a ``layout`` (``flat_layout``
of the configuration) gives the kernel each leaf's offset. The TPU kernel's
``pack_state`` / ``unpack_state`` and its n-major row layout existed to fill
TPU lanes and are not ported: the state is updated in place and needs no
sync.

The window of the kernel (``fused_map_fits``): NN mean and NN kernel of any
depths (at least one hidden layer each) and widths, feature_dim F <= 8,
tasks of N <= 8 points, and one block's shared memory holding the
parameters and its task group's rows and activations, the test of the
kernel's first design (a cooperative grid of up to 128 blocks). The kernel
now runs one thread-block cluster of C CTAs (``map_plan`` chooses C; each
CTA holds the parameters, a group of tasks and a slice of P); where one
cluster's CTAs cannot hold the tasks' rows, the plan keeps the first
design.
"""

import functools

import numpy as np
import torch

from meta_learning_pacoh_torch.models.gp_base import GPConfig, gp_prior_mll_batch
from meta_learning_pacoh_torch.models.random_gp import flat_layout, layout_dim, unravel_flat
from meta_learning_pacoh_torch.ops import cuda
from meta_learning_pacoh_torch.ops.cuda.build import launch
from meta_learning_pacoh_torch.ops.cuda.fused_svgd_kernel import slice_len
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

MAX_N = 8  # the per-task factorization is unrolled in registers
MAX_F = 8
MAX_GROUPS = 128  # blocks of the first design's cooperative launch; tasks beyond are grouped
SMEM_BYTES = 232448  # shared memory one Hopper block can use
# Cluster sizes in the order the plan tries them, fastest first at the demo
# (tools/fused_step_bench.py --map on the H100); 16 is a non-portable size.
CLUSTER_SIZES = (8, 4, 2, 1)
MAX_CLUSTER = 16


def map_layout(d, f, mean_hidden, kernel_hidden):
    """Flat layout of the kernel's configuration: NN/NN, the MAP flavour."""
    return flat_layout(GPConfig(input_dim=d, feature_dim=f, mean_nn_layers=tuple(mean_hidden),
                                kernel_nn_layers=tuple(kernel_hidden)))


def nets_of(layout):
    """(D, F, mean_hidden, kernel_hidden) of an NN/NN layout."""
    shapes = {path: shape for path, shape, _, _ in layout}

    def hidden(net):
        widths = []
        while (net, f"w_{len(widths)}") in shapes:
            widths.append(shapes[(net, f"w_{len(widths)}")][1])
        return tuple(widths)

    d = shapes[("mean_nn", "w_out" if not hidden("mean_nn") else "w_0")][0]
    return d, shapes[("lengthscale_raw",)][0], hidden("mean_nn"), hidden("kernel_nn")


def config_of(layout):
    d, f, mh, kh = nets_of(layout)
    return GPConfig(input_dim=d, feature_dim=f, mean_nn_layers=mh, kernel_nn_layers=kh)


def leaf_offsets(layout, mean_hidden, kernel_hidden):
    """Flat offsets in the kernel's order: per net (mean, kernel) w_l, b_l of
    every hidden layer, then w_out, b_out; then lengthscale_raw,
    outputscale_raw, noise_raw."""
    starts = {path: offset for path, _, offset, _ in layout}
    offs = []
    for net, hidden in (("mean_nn", mean_hidden), ("kernel_nn", kernel_hidden)):
        for i in range(len(hidden)):
            offs += [starts[(net, f"w_{i}")], starts[(net, f"b_{i}")]]
        offs += [starts[(net, "w_out")], starts[(net, "b_out")]]
    return offs + [starts[(name,)] for name in ("lengthscale_raw", "outputscale_raw",
                                                 "noise_raw")]


def task_groups(t):
    """(G blocks, tasks a block): T blocks up to MAX_GROUPS, else even groups."""
    tpb = -(-t // min(t, MAX_GROUPS))
    return -(-t // tpb), tpb


def smem_bytes(t, n, d, f, mean_hidden, kernel_hidden, p):
    """Shared memory of one block, as csrc/fused_map.cu lays it out."""
    _, tpb = task_groups(t)
    r = tpb * n
    return 4 * (p + r * (sum(mean_hidden) + sum(kernel_hidden)) + r * (d + 3 + f) + f
                + tpb * (f + 3))


def fused_map_fits(t, n, d, f, mean_hidden, kernel_hidden):
    """Whether the kernel takes this configuration."""
    mean_hidden, kernel_hidden = tuple(mean_hidden), tuple(kernel_hidden)
    if not (t >= 1 and d >= 1 and 1 <= n <= MAX_N and 1 <= f <= MAX_F
            and len(mean_hidden) >= 1 and len(kernel_hidden) >= 1):
        return False
    p = layout_dim(map_layout(d, f, mean_hidden, kernel_hidden))
    return smem_bytes(t, n, d, f, mean_hidden, kernel_hidden, p) <= SMEM_BYTES


def cluster_smem_bytes(t, n, d, f, p, sum_h, c):
    """Shared memory of one CTA of a cluster of c, as csrc/fused_map.cu lays
    it out (cluster_smem_floats): the parameters, the CTA's partial gradient
    and loss, the AdamW moments of its slice, both nets' activations with
    the odd pitch rmax | 1, its rows and their compaction to the drawn
    tasks', the nets' outputs, per-task partials, weights and indices."""
    tmax = -(-t // c)
    rmax = tmax * n
    return 4 * (2 * p + 1 + 2 * slice_len(p, c) + sum_h * (rmax | 1) + rmax * (2 * d + 5 + f)
                + tmax * (f + 5) + f + 4)


def nets_tiled(mean_hidden, kernel_hidden):
    """Whether both nets take csrc/map_tiles.cuh's register tiles: every
    hidden width a multiple of their 4 units (else map_nets.cuh's scalar
    passes)."""
    return all(h % 4 == 0 for h in tuple(mean_hidden) + tuple(kernel_hidden))


def cluster_fits(t, n, d, f, mean_hidden, kernel_hidden, c):
    """Whether one cluster of c CTAs holds this configuration: no more CTAs
    than tasks, and each CTA within one Hopper block's shared memory."""
    p = layout_dim(map_layout(d, f, mean_hidden, kernel_hidden))
    sum_h = sum(mean_hidden) + sum(kernel_hidden)
    return 1 <= c <= min(t, MAX_CLUSTER) and cluster_smem_bytes(t, n, d, f, p, sum_h, c) <= SMEM_BYTES


def map_plan(t, n, d, f, mean_hidden, kernel_hidden, cluster=None):
    """(C, tiled nets) of a launch: C CTAs of one thread-block cluster, the
    first size of ``CLUSTER_SIZES`` that ``cluster_fits``; C = 0 where none
    does (the first design's cooperative grid, ``task_groups``); tiled nets
    where every width is a multiple of 4. ``cluster`` forces C (the
    learners never pass it)."""
    sizes = CLUSTER_SIZES if cluster is None else (int(cluster),)
    c = next((c for c in sizes if cluster_fits(t, n, d, f, mean_hidden, kernel_hidden, c)), 0)
    if cluster is not None and c == 0:
        raise ValueError(f"fused_map: no cluster of {cluster} CTAs holds T={t}, N={n}, D={d}, "
                         f"F={f}, mean_hidden={mean_hidden}, kernel_hidden={kernel_hidden}")
    return c, nets_tiled(mean_hidden, kernel_hidden)


def task_weights(mask):
    """Per-task MLL weight 1 / n_t (0 for an empty task), as float32. Unlike
    the SVGD kernel's there is no harmonic pre-factor: the MAP loss is the
    plain sum of the per-task MLL / n_t."""
    sizes = np.asarray(mask, np.float32).sum(axis=-1)
    return np.where(sizes > 0, 1.0 / np.maximum(sizes, 1.0), 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_operands(layout, device):
    _, _, mh, kh = nets_of(layout)
    offs = torch.tensor(leaf_offsets(layout, mh, kh), dtype=torch.int32)
    widths = torch.tensor(mh + kh, dtype=torch.int32)
    return offs.to(device), widths.to(device)


def fused_map_train_ref(theta, mu, nu, x, y, mask, w_t, step0, lr, weight_decay, counts=None,
                        *, layout, n_steps):
    """Plain PyTorch version of ``fused_map_train``, updating in place.

    Each step: the loss -sum_t MLL_t (count-weighted with ``counts[i]`` when
    given, a never-drawn task adding exactly 0) by ``gp_prior_mll_batch``,
    its gradient by autograd, and the AdamW update of
    fused_map_kernel.py:168-182. ``w_t`` must be the weights the MLL / n
    applies, ``task_weights(mask)``.
    """
    want_w = torch.from_numpy(task_weights(mask.cpu().numpy())).to(w_t.device)
    if not torch.allclose(w_t, want_w, rtol=1e-6, atol=0.0):
        raise ValueError("fused_map: w_t differs from task_weights(mask)")
    cfg = config_of(layout)
    losses = []
    for i in range(n_steps):
        p = theta.detach().requires_grad_(True)
        lls = gp_prior_mll_batch(cfg, unravel_flat(layout, p[None]), x, y, mask)[0]
        if counts is not None:
            c = counts[i]
            lls = torch.where(c > 0, c * torch.where(c > 0, lls, 0.0), 0.0)
        loss = -torch.sum(lls)
        (g,) = torch.autograd.grad(loss, p)
        with torch.no_grad():
            cuda.adam_step_(theta, mu, nu, g, step0 + i + 1, lr, weight_decay)
        losses.append(loss.detach())
    return losses[-1], torch.mean(torch.stack(losses))


def fused_map_train(theta, mu, nu, x, y, mask, w_t, step0, lr, weight_decay, counts=None,
                    *, layout, n_steps, cluster=None):
    """n_steps of PACOH-MAP on flat parameters theta [P] and AdamW moments
    mu, nu [P], all updated in place. Returns (last loss, mean loss) of the
    steps as device scalars.

    x [T, N, D], y [T, N], mask [T, N]; w_t [T] = ``task_weights(mask)``;
    step0 the global step of the first step (its bias corrections); lr the
    launch's learning rate; counts [n_steps, T] the per-step task-draw
    counts of a sampled batch, or None for the full batch; layout the
    configuration's ``flat_layout``; ``cluster`` forces the cluster size
    (tests and tools only; ``map_plan``). The plain version for CPU
    tensors, the kernel for CUDA tensors.
    """
    if n_steps < 1:
        raise ValueError(f"fused_map: n_steps must be >= 1, got {n_steps}")
    if theta.device.type == "cpu":
        return fused_map_train_ref(theta, mu, nu, x, y, mask, w_t, step0, lr, weight_decay,
                                   counts, layout=layout, n_steps=n_steps)
    operands = [("theta", theta, 1), ("mu", mu, 1), ("nu", nu, 1), ("x", x, 3), ("y", y, 2),
                ("mask", mask, 2), ("w_t", w_t, 1)]
    if counts is not None:
        operands.append(("counts", counts, 2))
    for name, t_, ndim in operands:
        cuda.check_operand(f"fused_map {name}", t_, ndim)
        if t_.device != theta.device:
            raise ValueError(f"fused_map {name}: on {t_.device}, theta on {theta.device}")
    d, f, mh, kh = nets_of(layout)
    t, n, dx = x.shape
    p = layout_dim(layout)
    if dx != d or not fused_map_fits(t, n, d, f, mh, kh):
        raise ValueError(f"fused_map: the kernel does not take T={t}, N={n}, D={dx}, F={f}, "
                         f"mean_hidden={mh}, kernel_hidden={kh}")
    if (theta.shape != (p,) or mu.shape != (p,) or nu.shape != (p,) or y.shape != (t, n)
            or mask.shape != (t, n) or w_t.shape != (t,)
            or (counts is not None and counts.shape != (n_steps, t))):
        raise ValueError("fused_map: operand shapes do not match theta [P] and x [T, N, D]")
    offs, widths = _device_operands(layout, theta.device)
    c, tiled = map_plan(t, n, d, f, mh, kh, cluster)
    loss = torch.empty(2, dtype=theta.dtype, device=theta.device)
    common = (theta.data_ptr(), mu.data_ptr(), nu.data_ptr(), x.data_ptr(), y.data_ptr(),
              mask.data_ptr(), w_t.data_ptr(), None if counts is None else counts.data_ptr(),
              offs.data_ptr(), widths.data_ptr())
    shape = (t, n, d, f, len(mh), len(kh), sum(mh), sum(kh), p, int(n_steps))
    hyper = (float(step0), float(lr), float(weight_decay), float(config_of(layout).noise_floor))
    if c:
        launch("pacoh_fused_map_cluster", theta, *common, loss.data_ptr(), *shape, c, int(tiled),
               *hyper)
    else:  # the first design: a cooperative grid of task groups
        groups, tpb = task_groups(t)
        gbuf = torch.empty(groups, p + 1, dtype=theta.dtype, device=theta.device)
        launch("pacoh_fused_map", theta, *common, gbuf.data_ptr(), loss.data_ptr(), *shape,
               groups, tpb, *hyper)
    cuda.LAUNCHES["fused_map"] += 1
    return loss[0], loss[1] / n_steps


class FusedMAPTrainer:
    """Host-side trainer of the fused kernel over a learner's flat state.

    It folds the per-task weights 1 / n_t once, splits a run into launches
    that cross no staircase boundary of the lr schedule, and in the
    sampled-batch mode (task_batch_size < T) builds each launch's count
    pages from ``task_draw(step)``, the learner's own task indices of a
    global step, so the fused and the general step follow one random
    trajectory. The state is the caller's tensors, updated in place.
    """

    MAX_LAUNCH = 512  # steps a launch in the sampled mode (bounds its count pages)
    train_fn = staticmethod(fused_map_train)  # the kernel a launch runs

    @spanned(TRAINER_BUILD)
    def __init__(self, X, Y, mask, *, layout, lr, weight_decay, lr_decay=1.0,
                 task_batch_size=None, task_draw=None):
        self.X, self.Y, self.mask = X, Y, mask
        self.n_tasks = int(X.shape[0])
        self.layout = layout
        self.lr, self.lr_decay = float(lr), float(lr_decay)
        self.weight_decay = float(weight_decay)
        self.counted = task_batch_size is not None and int(task_batch_size) != self.n_tasks
        if self.counted and task_draw is None:
            raise ValueError("a sampled task batch needs task_draw")
        self.task_draw = task_draw
        self.w_t = torch.from_numpy(task_weights(mask.cpu().numpy())).to(X.device)

    @spanned(TRAINER_PAGES)
    def count_pages(self, step0, n_steps):
        return count_pages(self.task_draw, self.n_tasks, step0, n_steps).to(self.X.device)

    def launches(self, step0, n_steps):
        """(launch_step0, sub_steps) of a run of n_steps from global step step0."""
        cap = self.MAX_LAUNCH if self.counted else int(n_steps)
        return staircase_launches(step0, n_steps, cap, self.lr_decay)

    def launch(self, theta, mu, nu, step0, n_steps):
        counts = self.count_pages(step0, n_steps) if self.counted else None
        with span(TRAINER_LAUNCH):
            return self.train_fn(theta, mu, nu, self.X, self.Y, self.mask, self.w_t, step0,
                                 staircase_lr(self.lr, self.lr_decay, step0),
                                 self.weight_decay, counts, layout=self.layout,
                                 n_steps=n_steps)

    def run(self, theta, mu, nu, n_steps, step0):
        """n_steps from global step step0; (last loss, mean loss) as device scalars."""
        last, total = None, 0.0
        for s, sub in self.launches(step0, n_steps):
            last, mean = self.launch(theta, mu, nu, s, sub)
            total = total + mean * sub
        return last, total / n_steps
