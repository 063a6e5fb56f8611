"""Big-N fused PACOH-MAP training kernel (csrc/fused_map_bign.cu), its plain version, and its trainer.

Replaces meta_learning_pacoh_tpu/ops/pallas/fused_map_bign_kernel.py
(``fused_map_bign_train_packed``, the Pallas kernel of ``_make_kernel``,
``bign_fits`` and ``FusedMAPBigNTrainer``): the sibling of the N <= 8 kernel
(ops/cuda/fused_map_kernel.py) for tasks of 9 <= N <= 512 points, the
Swissfel/Physionet window. One launch runs ``n_steps`` PACOH-MAP iterations
on the learner's flat state, with the same AdamW, count pages and launch
plan as the N <= 8 kernel; the per-task GP algebra is the blocked one of
csrc/blocked_factor.cuh, shared with the blocked MLL kernel (B4).

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
from meta_learning_pacoh_torch.ops.cuda.blocked_mll_kernel import PANEL, SMEM_BYTES
from meta_learning_pacoh_torch.ops.cuda.build import launch
from meta_learning_pacoh_torch.ops.cuda.chol_kernel import cholesky_ref, diag_ok
from meta_learning_pacoh_torch.ops.cuda.fused_map_kernel import (
    FusedMAPTrainer,
    _device_operands,
    config_of,
    map_layout,
    nets_of,
    task_groups,
    task_weights,
)
from meta_learning_pacoh_torch.ops.cuda.mll_kernel import JITTERS
from meta_learning_pacoh_torch.ops.gp import add_noise_masked

MIN_N, MAX_N = 9, 512  # below: the N <= 8 kernel; above: the TPU kernel's window
MAX_F = 8
SCRATCH_BYTES = 2 ** 30  # device scratch a launch may take
_LOG_2PI = math.log(2.0 * math.pi)


def smem_bytes(tpb, n, d, f, p, shared):
    """Shared memory of one block, as csrc/fused_map_bign.cu lays it out: the
    parameters, the block's rows, a few per-point vectors and, when
    ``shared``, the task's N x N matrix with an odd leading dimension."""
    r = tpb * n
    return 4 * (p + r * (d + 3 + f) + f + (f + 3) + 3 * n + n * (2 * f + 2) + PANEL * n + 1
                + (n * (n | 1) if shared else 0))


def bign_plan(t, n, d, f, mean_hidden, kernel_hidden):
    """(blocks, tasks a block, matrix in shared memory) of the kernel at this
    configuration, or None where it does not take it.

    The kernel takes NN mean and NN kernel nets of any depths (at least one
    hidden layer each) and widths, 9 <= N <= 512, F <= 8, any T. It is one
    cooperative launch, so every block must be resident at once: the tasks
    go to at most 128 blocks (B6's grouping), each of 512 threads and at most
    one Hopper block's shared memory, which 132 SMs hold one a SM. It
    refuses a configuration whose parameters and rows do not fit one block's
    shared memory even with the matrix in device memory, or whose device
    scratch (partial gradients, activations, matrices) exceeds 1 GiB. The
    TPU's VMEM test (4 Tp Np^2 floats within 72 MB) does not apply.
    """
    mean_hidden, kernel_hidden = tuple(mean_hidden), tuple(kernel_hidden)
    if not (t >= 1 and d >= 1 and MIN_N <= n <= MAX_N and 1 <= f <= MAX_F
            and len(mean_hidden) >= 1 and len(kernel_hidden) >= 1):
        return None
    p = layout_dim(map_layout(d, f, mean_hidden, kernel_hidden))
    groups, tpb = task_groups(t)
    shared = smem_bytes(tpb, n, d, f, p, True) <= SMEM_BYTES
    if not shared and smem_bytes(tpb, n, d, f, p, False) > SMEM_BYTES:
        return None
    scratch = 4 * groups * ((p + 1) + tpb * n * (sum(mean_hidden) + sum(kernel_hidden))
                            + (0 if shared else n * n))
    if scratch > SCRATCH_BYTES:
        return None
    return groups, tpb, shared


def bign_fits(t, n, d, f, mean_hidden, kernel_hidden):
    """Whether the kernel takes this configuration (see ``bign_plan``)."""
    return bign_plan(t, n, d, f, mean_hidden, kernel_hidden) is not None


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


def bign_task_mll(layout, theta, x, y, mask):
    """Per-task MLL / n_t [T] at flat parameters theta [P] under the kernel's
    rule (``real_rows_mll``)."""
    cfg = config_of(layout)
    params = unravel_flat(layout, theta[None])
    mean = gp_mean(cfg, params, x[None])[0]
    K = gp_gram(cfg, params, x[None])[0]
    noise = gp_noise(cfg, params)[0]
    return real_rows_mll(mean, K, y, noise.expand(y.shape[:-1]), mask)


def fused_map_bign_train_ref(theta, mu, nu, x, y, mask, w_t, step0, lr, weight_decay,
                             counts=None, *, layout, n_steps):
    """Plain PyTorch version of ``fused_map_bign_train``, updating in place:
    each step the loss -sum_t MLL_t of ``bign_task_mll`` (count-weighted with
    ``counts[i]``, a never-drawn task adding exactly 0), its gradient by
    autograd, and the kernels' AdamW (``cuda.adam_step_``)."""
    want_w = torch.from_numpy(task_weights(mask.cpu().numpy())).to(w_t.device)
    if not torch.allclose(w_t, want_w, rtol=1e-6, atol=0.0):
        raise ValueError("fused_map_bign: w_t differs from task_weights(mask)")
    losses = []
    for i in range(n_steps):
        p = theta.detach().requires_grad_(True)
        lls = bign_task_mll(layout, p, x, y, mask)
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
    groups, tpb, shared = plan
    offs, widths = _device_operands(layout, theta.device)
    gbuf = torch.empty(groups, p + 1, dtype=theta.dtype, device=theta.device)
    act = torch.empty(groups, tpb * n * (sum(mh) + sum(kh)), dtype=theta.dtype,
                      device=theta.device)
    work = None if shared else torch.empty(groups, n, n, dtype=theta.dtype, device=theta.device)
    loss = torch.empty(2, dtype=theta.dtype, device=theta.device)
    launch("pacoh_fused_map_bign", theta, theta.data_ptr(), mu.data_ptr(), nu.data_ptr(),
           x.data_ptr(), y.data_ptr(), mask.data_ptr(), w_t.data_ptr(),
           None if counts is None else counts.data_ptr(), offs.data_ptr(), widths.data_ptr(),
           gbuf.data_ptr(), act.data_ptr(), None if work is None else work.data_ptr(),
           loss.data_ptr(), t, n, d, f, len(mh), len(kh), sum(mh), sum(kh), p, int(n_steps),
           groups, tpb, int(shared), float(step0), float(lr), float(weight_decay),
           float(config_of(layout).noise_floor))
    cuda.LAUNCHES["fused_map_bign"] += 1
    return loss[0], loss[1] / n_steps


class FusedMAPBigNTrainer(FusedMAPTrainer):
    """``FusedMAPTrainer`` for tasks of 9 <= N <= 512: the same host
    interface (layout, task weights, count pages from the learner's draws,
    staircase launches, the caller's state updated in place, so a fit
    resumes from the live moments), launching the big-N kernel."""

    train_fn = staticmethod(fused_map_bign_train)
