"""Big-N fused PACOH-MAP training kernel (csrc/fused_map_bign.cu), its plain version, and its trainer.

Replaces meta_learning_pacoh_tpu/ops/pallas/fused_map_bign_kernel.py
(``fused_map_bign_train_packed``, the Pallas kernel of ``_make_kernel``,
``bign_fits`` and ``FusedMAPBigNTrainer``): the sibling of the N <= 8 kernel
(ops/cuda/fused_map_kernel.py) for tasks of 9 <= N <= 512 points, the
Swissfel/Physionet window. One launch runs ``n_steps`` PACOH-MAP iterations
on the learner's flat state, with the same AdamW and count pages as the
N <= 8 kernel; each task's GP system runs through the 32-column panels of
csrc/tiled_chol.cuh (the residual as its border row) and
csrc/tiled_inverse.cuh, as in the big-N SVGD and VI kernels (B10, B11), and
its nets through csrc/map_tiles.cuh's register tiles (or, for widths that
are no multiple of 4, csrc/map_nets.cuh's scalar passes).

One rule differs from the general step (``gp_mll_batch``): the escalated
jitter lands on the diagonal of a task's real rows only (the TPU kernel's
``eye * m_col``), not on its padded ones, so a ragged task that escalates
has a log-determinant n_padded log(1 + jitter) below the general step's.
The plain version here follows the kernel.

The TPU kernel's padding of N to a panel multiple and of the data to a
task-major [Tp Np, D] slab is not ported: the kernel reads the learner's
[T, N, D] data as it is.
"""

import math

import torch

from meta_learning_pacoh_torch.models.gp_base import gp_gram, gp_mean, gp_noise
from meta_learning_pacoh_torch.models.random_gp import layout_dim, unravel_flat
from meta_learning_pacoh_torch.ops import cuda
from meta_learning_pacoh_torch.ops.cuda.build import launch
from meta_learning_pacoh_torch.ops.cuda.chol_kernel import (
    SMEM_BYTES,
    cholesky_ref,
    diag_ok,
    tiled_scratch_bytes,
    tiled_shared_bytes,
)
from meta_learning_pacoh_torch.ops.cuda.fused_map_kernel import (
    FusedMAPTrainer,
    _device_operands,
    config_of,
    map_layout,
    nets_of,
    nets_tiled,
    task_groups,
    task_weights,
)
from meta_learning_pacoh_torch.ops.cuda.mll_kernel import JITTERS
from meta_learning_pacoh_torch.ops.gp import add_noise_masked

MIN_N, MAX_N = 9, 512  # below: the N <= 8 kernel; above: the TPU kernel's window
MAX_F = 8
SCRATCH_BYTES = 2 ** 30  # device scratch a launch may take
_LOG_2PI = math.log(2.0 * math.pi)


MAP_TILES = 16  # csrc/fused_map_bign.cu kMapTiles: diagonal tiles of N = 512
# the first design's shared memory bound (kPanel columns of a panel), kept for the window
_WINDOW_PANEL = 8


def window_bytes(tpb, n, d, f, p, matrix=False):
    """Shared memory of one block of the kernel's first design: the
    parameters, the block's rows, its per-point vectors and, with
    ``matrix``, the task's N x N matrix. The window (``bign_fits``) is the
    one the learners' dispatch was set by; ``bign_plan`` finds a plan for
    every shape in it."""
    r = tpb * n
    return 4 * (p + r * (d + 3 + f) + f + (f + 3) + 3 * n + n * (2 * f + 2) + _WINDOW_PANEL * n + 1
                + (n * (n | 1) if matrix else 0))


def window_fits(t, n, d, f, p, sum_h):
    """The first design's test: the block's parameters and rows in shared
    memory, its device scratch (partial gradients, activations and, where
    shared memory does not hold it, the matrix) within 1 GiB."""
    groups, tpb = task_groups(t)
    matrix = window_bytes(tpb, n, d, f, p, True) <= SMEM_BYTES
    scratch = 4 * groups * ((p + 1) + tpb * n * sum_h + (0 if matrix else n * n))
    return window_bytes(tpb, n, d, f, p) <= SMEM_BYTES and scratch <= SCRATCH_BYTES


def vector_floats(n, d, f):
    """Shared-memory floats of a task's rows, its per-point vectors and the
    hyperparameter sums and tile logs (csrc/fused_map_bign.cu, vector_floats)."""
    return n * (d + f + 7) + 2 * f + 4 + MAP_TILES


def smem_bytes(n, d, f, p, sum_h, shared, th_shared=True):
    """Shared memory of one block, as csrc/fused_map_bign.cu lays it out: the
    tiled matrix's scratch and, when ``shared`` >= 1, the packed rows of the
    task's system and its border row; the parameters when ``th_shared``; the
    task's rows and vectors; when ``shared`` is 2, both nets' activations
    (``sum_h`` hidden units in all) with the odd pitch N | 1."""
    return ((tiled_shared_bytes if shared else tiled_scratch_bytes)(n, n + 1)
            + 4 * ((p if th_shared else 0) + vector_floats(n, d, f)
                   + (sum_h * (n | 1) if shared == 2 else 0)))


def bign_plan(t, n, d, f, mean_hidden, kernel_hidden):
    """(blocks, tasks a block, placement, tiled nets, parameters in shared
    memory) of the kernel at this configuration, or None where it does not
    take it.

    The kernel takes NN mean and NN kernel nets of any depths (at least one
    hidden layer each) and widths, 9 <= N <= 512, F <= 8, any T, within the
    window of its first design (``window_bytes``: the parameters and a
    block's rows within one Hopper block's shared memory, its device
    scratch within 1 GiB). It is one cooperative launch, so every block must
    be resident at once: the tasks go to at most 128 blocks (B6's grouping),
    each of 512 threads, which 132 SMs hold one a SM. The placement is the
    most that fits shared memory beside the parameters: 2 the task's packed
    matrix and both nets' activations, 1 the matrix, 0 neither; where even
    0 does not fit, the parameters too move to device memory. The TPU's
    VMEM test (4 Tp Np^2 floats within 72 MB) does not apply.
    """
    mean_hidden, kernel_hidden = tuple(mean_hidden), tuple(kernel_hidden)
    if not (t >= 1 and d >= 1 and MIN_N <= n <= MAX_N and 1 <= f <= MAX_F
            and len(mean_hidden) >= 1 and len(kernel_hidden) >= 1):
        return None
    p = layout_dim(map_layout(d, f, mean_hidden, kernel_hidden))
    groups, tpb = task_groups(t)
    sum_h = sum(mean_hidden) + sum(kernel_hidden)
    if not window_fits(t, n, d, f, p, sum_h):
        return None
    for th_shared in (True, False):
        for shared in (2, 1, 0):
            if smem_bytes(n, d, f, p, sum_h, shared, th_shared) <= SMEM_BYTES:
                return groups, tpb, shared, nets_tiled(mean_hidden, kernel_hidden), th_shared
    return None


def bign_fits(t, n, d, f, mean_hidden, kernel_hidden):
    """Whether the kernel takes this configuration (see ``bign_plan``)."""
    return bign_plan(t, n, d, f, mean_hidden, kernel_hidden) is not None


def scratch_shapes(plan, n, p, sum_h):
    """name -> shape of the launch's device scratch under ``plan``: the
    blocks' partial gradients, one task's (several tasks a block), the
    parameters, the activations and the matrices where shared memory does
    not hold them."""
    groups, tpb, shared, _, th_shared = plan
    return {"gbuf": (groups, p + 1), "gtask": (groups, p + 1) if tpb > 1 else None,
            "th_dev": None if th_shared else (groups, p),
            "act": None if shared == 2 else (groups, sum_h * (n | 1)),
            "work": None if shared else (groups, n, n)}


def real_rows_mll(mean, K, y, noise, mask, level_dtype=None):
    """MLL / n of systems mean, y, mask [..., N], K [..., N, N], noise [...]
    under the big-N fused kernels' rule (B9, B10, B11): the jitter (0, 1e-4,
    1e-2) chosen per system, as a constant, and put on the real rows'
    diagonal only. ``level_dtype`` chooses the level by a factorization in
    that type (float32: as the kernels' own factor does) where it is not the
    systems' own."""
    Kn = add_noise_masked(K, noise, mask, 1e-6)
    eye_real = torch.diag_embed(mask)
    jit = torch.full(y.shape[:-1], JITTERS[-1], dtype=y.dtype, device=y.device)
    probe = Kn.detach() if level_dtype is None else Kn.detach().to(level_dtype)
    for j in reversed(JITTERS[:-1]):
        ok = diag_ok(cholesky_ref(probe + j * eye_real.to(probe.dtype)))
        jit = torch.where(ok, torch.full_like(jit, j), jit)
    L, info = torch.linalg.cholesky_ex(Kn + jit[..., None, None] * eye_real)
    L = torch.where((info > 0)[..., None, None], torch.nan, L)
    r = (y - mean) * mask
    z = torch.linalg.solve_triangular(L, r[..., None], upper=False)[..., 0]
    quad = torch.sum(z * z, dim=-1)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    n_eff = torch.sum(mask, dim=-1)
    return -0.5 * (quad + logdet + n_eff * _LOG_2PI) / n_eff


def bign_task_mll(layout, theta, x, y, mask, level_dtype=None):
    """Per-task MLL / n_t [T] at flat parameters theta [P] under the kernel's
    rule (``real_rows_mll``, its jitter levels chosen in ``level_dtype``)."""
    cfg = config_of(layout)
    params = unravel_flat(layout, theta[None])
    mean = gp_mean(cfg, params, x[None])[0]
    K = gp_gram(cfg, params, x[None])[0]
    noise = gp_noise(cfg, params)[0]
    return real_rows_mll(mean, K, y, noise.expand(y.shape[:-1]), mask, level_dtype)


def fused_map_bign_train_ref(theta, mu, nu, x, y, mask, w_t, step0, lr, weight_decay,
                             counts=None, *, layout, n_steps, level_dtype=None):
    """Plain PyTorch version of ``fused_map_bign_train``, updating in place:
    each step the loss -sum_t MLL_t of ``bign_task_mll`` (count-weighted with
    ``counts[i]``, a never-drawn task adding exactly 0; the jitter levels
    chosen in ``level_dtype``), its gradient by autograd, and the kernels'
    AdamW (``cuda.adam_step_``)."""
    want_w = torch.from_numpy(task_weights(mask.cpu().numpy())).to(w_t.device)
    if not torch.allclose(w_t, want_w, rtol=1e-6, atol=0.0):
        raise ValueError("fused_map_bign: w_t differs from task_weights(mask)")
    losses = []
    for i in range(n_steps):
        p = theta.detach().requires_grad_(True)
        lls = bign_task_mll(layout, p, x, y, mask, level_dtype)
        if counts is not None:
            c = counts[i]
            lls = torch.where(c > 0, c * torch.where(c > 0, lls, 0.0), 0.0)
        loss = -torch.sum(lls)
        (g,) = torch.autograd.grad(loss, p)
        with torch.no_grad():
            cuda.adam_step_(theta, mu, nu, g, step0 + i + 1, lr, weight_decay)
        losses.append(loss.detach())
    return losses[-1], torch.mean(torch.stack(losses))


def fused_map_bign_train(theta, mu, nu, x, y, mask, w_t, step0, lr, weight_decay, counts=None,
                         *, layout, n_steps):
    """n_steps of PACOH-MAP on flat parameters theta [P] and AdamW moments
    mu, nu [P], all updated in place; the arguments and results of
    ``fused_map_kernel.fused_map_train``, for tasks of 9 <= N <= 512. The
    plain version for CPU tensors, the kernel for CUDA tensors."""
    if n_steps < 1:
        raise ValueError(f"fused_map_bign: n_steps must be >= 1, got {n_steps}")
    if theta.device.type == "cpu":
        return fused_map_bign_train_ref(theta, mu, nu, x, y, mask, w_t, step0, lr, weight_decay,
                                        counts, layout=layout, n_steps=n_steps)
    operands = [("theta", theta, 1), ("mu", mu, 1), ("nu", nu, 1), ("x", x, 3), ("y", y, 2),
                ("mask", mask, 2), ("w_t", w_t, 1)]
    if counts is not None:
        operands.append(("counts", counts, 2))
    for name, t_, ndim in operands:
        cuda.check_operand(f"fused_map_bign {name}", t_, ndim)
        if t_.device != theta.device:
            raise ValueError(f"fused_map_bign {name}: on {t_.device}, theta on {theta.device}")
    d, f, mh, kh = nets_of(layout)
    t, n, dx = x.shape
    p = layout_dim(layout)
    plan = bign_plan(t, n, d, f, mh, kh)
    if dx != d or plan is None:
        raise ValueError(f"fused_map_bign: the kernel does not take T={t}, N={n}, D={dx}, F={f}, "
                         f"mean_hidden={mh}, kernel_hidden={kh}")
    if (theta.shape != (p,) or mu.shape != (p,) or nu.shape != (p,) or y.shape != (t, n)
            or mask.shape != (t, n) or w_t.shape != (t,)
            or (counts is not None and counts.shape != (n_steps, t))):
        raise ValueError("fused_map_bign: operand shapes do not match theta [P] and x [T, N, D]")
    groups, tpb, shared, tiled, th_shared = plan
    offs, widths = _device_operands(layout, theta.device)
    scratch = {name: None if shape is None
               else torch.empty(*shape, dtype=theta.dtype, device=theta.device)
               for name, shape in scratch_shapes(plan, n, p, sum(mh) + sum(kh)).items()}
    loss = torch.empty(2, dtype=theta.dtype, device=theta.device)
    launch("pacoh_fused_map_bign", theta, theta.data_ptr(), mu.data_ptr(), nu.data_ptr(),
           x.data_ptr(), y.data_ptr(), mask.data_ptr(), w_t.data_ptr(),
           None if counts is None else counts.data_ptr(), offs.data_ptr(), widths.data_ptr(),
           *(None if a is None else a.data_ptr() for a in scratch.values()),
           loss.data_ptr(), t, n, d, f, len(mh), len(kh), sum(mh), sum(kh), p, int(n_steps),
           groups, tpb, int(shared), int(tiled), int(th_shared), float(step0), float(lr),
           float(weight_decay), float(config_of(layout).noise_floor))
    cuda.LAUNCHES["fused_map_bign"] += 1
    return loss[0], loss[1] / n_steps


class FusedMAPBigNTrainer(FusedMAPTrainer):
    """``FusedMAPTrainer`` for tasks of 9 <= N <= 512: the same host
    interface (layout, task weights, count pages from the learner's draws,
    staircase launches, the caller's state updated in place, so a fit
    resumes from the live moments), launching the big-N kernel."""

    train_fn = staticmethod(fused_map_bign_train)
