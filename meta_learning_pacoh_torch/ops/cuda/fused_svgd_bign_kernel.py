"""Big-N fused PACOH-SVGD training kernel (csrc/fused_svgd_bign.cu), its plain version, and its trainer.

Replaces meta_learning_pacoh_tpu/ops/pallas/fused_svgd_bign_kernel.py
(``fused_svgd_bign_train_packed``, the Pallas kernel of ``_make_kernel``,
``svgd_bign_fits``, ``svgd_bign_wins`` and ``FusedSVGDBigNTrainer``): the
sibling of the N <= 8 kernel (ops/cuda/fused_svgd_kernel.py) for tasks of
9 <= N <= 256 points, the Swissfel/Physionet window. One launch runs
``n_steps`` PACOH-SVGD iterations of K particles on the learner's flat
``[K, P]`` state, with the same Adam, count pages and launch plan as the
N <= 8 kernel; the per-(particle, task) GP algebra is the blocked one of
csrc/tiled_chol.cuh and csrc/tiled_inverse.cuh, in csrc/bign_score.cuh
(shared with the big-N VI kernel).

One rule differs from the general step (``gp_prior_mll_batch``): the
escalated jitter lands on the diagonal of a task's real rows only (the TPU
kernel's ``eye * m_col``), as in the big-N MAP kernel
(``fused_map_bign_kernel.real_rows_mll``). In a ragged task that escalates
the two differ by a constant of the log-determinant, which leaves the score
unchanged. The plain version here follows the kernel.

The TPU kernel's padding of N to a multiple of 64 and of the systems to a
chunk of 16, its N >= 128 floor (a Mosaic lowering limit) and its task-major
data slab are not ported: the kernel reads the learner's [T, N, D] data as
it is.
"""

import functools

import torch

from meta_learning_pacoh_torch import config
from meta_learning_pacoh_torch.models.gp_base import gp_gram, gp_mean, gp_noise
from meta_learning_pacoh_torch.ops import cuda
from meta_learning_pacoh_torch.ops.cuda.build import launch
from meta_learning_pacoh_torch.ops.cuda.chol_kernel import (
    SMEM_BYTES,
    tiled_scratch_bytes,
    tiled_shared_bytes,
)
from meta_learning_pacoh_torch.ops.cuda.fused_map_bign_kernel import SCRATCH_BYTES, real_rows_mll
from meta_learning_pacoh_torch.ops.cuda.fused_map_kernel import task_groups
from meta_learning_pacoh_torch.ops.cuda.fused_svgd_kernel import (
    MAX_K,
    FusedSVGDTrainer,
    _device_operands,
    fused_prior,
    fused_svgd_train_ref,
)

MIN_N, MAX_N = 9, 256  # below: the N <= 8 kernel; above: the TPU kernel's window
# the widest grouping of the H100 faceoff that the kernels won (``bign_wins``)
MAX_WON_SYSTEMS_A_BLOCK = 8
N_SM = 132  # SMs of an H100 SXM
SM_SMEM_BYTES = 233472  # shared memory of one Hopper SM
BLOCK_RESERVED_SMEM = 1024  # of it, what the runtime keeps for each resident block
THREADS = 512  # csrc/fused_svgd_bign.cu's kThreads: a block's width, alone on its SM
# The largest N whose every phase covers its rows at THREADS // 2 threads:
# tiled_wt_times gives each row one group of lanes with no stride
# (csrc/tiled_inverse.cuh), N <= blockDim.x; every other phase strides.
N_WIDE = 256


def matrix_bytes(n, shared):
    """Shared memory of a system's tiled matrix (csrc/bign_score.cuh,
    bign_matrix_floats): the scratch of csrc/tiled_chol.cuh and, when
    ``shared``, the packed rows of the N x N system and its border row."""
    return (tiled_shared_bytes if shared else tiled_scratch_bytes)(n, n + 1)


def vector_bytes(n, d):
    """Shared memory of a system's rows and per-point vectors beside its
    parameters (csrc/bign_score.cuh, bign_vector_floats)."""
    return 4 * (n * (d + 10) + 16)


def act_bytes(n, hidden, shared):
    """Shared memory of both nets' activations [2][L][H][N | 1] (an odd row
    pitch), held there when ``shared`` is 2 (csrc/bign_score.cuh,
    bign_act_floats)."""
    return 4 * 2 * (n | 1) * sum(hidden) if shared == 2 else 0


def smem_bytes(k, n, d, p, shared, hidden=()):
    """Shared memory of one block, as csrc/fused_svgd_bign.cu lays it out:
    the tiled matrix's area, one particle, the task's rows and per-point
    vectors, the K x K distances and kernel matrix and, when ``shared`` is 2,
    the activations of nets of ``hidden`` widths."""
    return (matrix_bytes(n, shared) + vector_bytes(n, d) + 4 * (p + 2 * k * k + k + 1)
            + act_bytes(n, hidden, shared))


def systems_plan(g, n, smem_fn, scratch_floats, per_sm=1):
    """(blocks, systems a block, placement) of a big-N kernel on g systems of
    n points at ``per_sm`` blocks an SM of THREADS // per_sm threads, or
    None, so that 132 SMs hold every block of the cooperative launch at once.
    The placement is the most that fits one Hopper block's shared memory
    (``smem_fn(placement)`` bytes): 2 the matrix and the nets' activations, 1
    the matrix (the activations in device memory), 0 neither; ``per_sm``
    blocks of it must fit an SM. One block an SM takes B9's grouping, at most
    128 blocks; two take ceil(g / (2 N_SM)) systems a block.
    ``scratch_floats(blocks, placement)`` of device scratch must stay under 1
    GiB."""
    shared = next((s for s in (2, 1, 0) if smem_fn(s) <= SMEM_BYTES), None)
    if shared is None:
        return None
    if per_sm == 1:
        blocks, spb = task_groups(g)
    elif per_sm * (smem_fn(shared) + BLOCK_RESERVED_SMEM) > SM_SMEM_BYTES:
        return None
    else:
        spb = -(-g // (N_SM * per_sm))
        blocks = -(-g // spb)
    if 4 * scratch_floats(blocks, shared) > SCRATCH_BYTES:
        return None
    return blocks, spb, shared


def svgd_bign_plan(k, t, n, d, hidden):
    """(blocks, systems a block, placement in shared memory, threads a block)
    of the kernel at this configuration, or None where it does not take it.

    The kernel takes NN mean and NN kernel nets of one hidden width (feature
    dim 1), 1 <= K <= 32 particles (the transport keeps the K x K distances
    in shared memory), 9 <= N <= 256 and any T; the G = K T systems as
    ``systems_plan`` places them, the device scratch being the systems'
    partial gradients [G, P], the particles twice and, where they do not fit
    shared memory, the activations (N > 201 at nets 32x32) and the matrices
    (wide nets). The TPU's VMEM test and N >= 128 floor do not apply.

    Where the systems outnumber the SMs (G > N_SM), N <= N_WIDE and two
    blocks' shared memory fits an SM, two blocks of 256 threads share each
    SM (``cauchy_20``: 200 blocks of one system each); elsewhere one block
    of 512 threads an SM.

    Where the learners take it is ``bign_wins``."""
    hidden = tuple(hidden)
    if not (1 <= k <= MAX_K and t >= 1 and d >= 1 and MIN_N <= n <= MAX_N
            and len(hidden) >= 1 and len(set(hidden)) == 1):
        return None
    p = fused_prior(d, hidden, 1.0, 1.0).dim
    g = k * t

    def smem(shared):
        return smem_bytes(k, n, d, p, shared, hidden)

    def scratch(blocks, shared):
        return (g * p + 2 * k * p + k * k
                + (0 if shared == 2 else blocks * 2 * (n | 1) * sum(hidden))
                + (0 if shared else blocks * n * n))

    for per_sm in (2, 1) if g > N_SM and n <= N_WIDE else (1,):
        plan = systems_plan(g, n, smem, scratch, per_sm)
        if plan is not None:
            return plan + (THREADS // per_sm,)
    return None


def svgd_bign_fits(k, t, n, d, hidden):
    """Whether the kernel takes this configuration (see ``svgd_bign_plan``)."""
    return svgd_bign_plan(k, t, n, d, hidden) is not None


def bign_wins(g):
    """The measured dispatch policy of the big-N SVGD and VI kernels (the TPU
    learner's ``svgd_bign_wins``), for a fit of g = K T (S T) systems that
    the kernel takes: whether the learner takes it by default.

    On an H100 (80GB HBM3, 700 W) chip_smoke.py's phase 9 faceoff
    (tools/torch_bign_policy.py) ran both learners at K = S = 10, full
    batch, on their fused kernels and on their general steps, at the
    corners of the window: the kernels won everywhere. SVGD: N=9 with 50
    systems 105.2x, cauchy_20 (N=20, 200 systems) 58.1x, N=48
    68.9x, N=128 38.8x, N=200 (svgd_t5_n200) 17.3x, N=256 12.6x, N=200 with
    200 systems 10.1x, N=48 with 1000 systems (8 a block) 9.2x, N=256 with
    1000 systems 7.4x; VI 85.1x, 54.2x, 53.0x, 32.0x, 16.3x, 11.2x, 9.7x,
    9.5x, 7.1x. So the learners take both kernels by default up to
    MAX_WON_SYSTEMS_A_BLOCK systems a block of the grouping at one block an
    SM (g <= 1024, the faceoff's grouping), where the v5e's
    0.63-0.99x kept the TPU learner off them; beyond the shapes measured
    the default is the general step and ``PACOH_TORCH_FORCE_BIGN_FUSED=1``
    turns the kernels on. ``PACOH_TORCH_DISABLE_FUSED=1`` turns them off
    everywhere."""
    return config.force_bign_fused() or task_groups(g)[1] <= MAX_WON_SYSTEMS_A_BLOCK


def bign_prior_mll_batch(cfg, params, X, Y, mask, level_dtype=None):
    """``gp_prior_mll_batch`` under the big-N kernels' jitter rule
    (``real_rows_mll``, which takes ``level_dtype``): MLL / n of T tasks under
    each of K parameter sets, X [T, N, D], Y [T, N], mask [T, N] -> [K, T]."""
    k = params["noise_raw"].shape[0]
    shape = (k,) + tuple(Y.shape)
    x = X.expand(k, *X.shape)
    return real_rows_mll(gp_mean(cfg, params, x), gp_gram(cfg, params, x), Y.expand(shape),
                         gp_noise(cfg, params)[:, None].expand(shape[:-1]), mask.expand(shape),
                         level_dtype)


def fused_svgd_bign_train_ref(theta, mu, nu, x, y, mask, w_t, step0, lr, prior_factor,
                              counts=None, *, hidden, wps, bps, n_steps, level_dtype=None):
    """Plain PyTorch version of ``fused_svgd_bign_train``, updating in place:
    each step the score by autograd of ``meta_log_prob`` with the task MLLs
    of ``bign_prior_mll_batch`` (torch.linalg, no kernel; its jitter levels
    chosen in ``level_dtype``), ``svgd_phi_ref`` and the kernels' Adam, as
    ``fused_svgd_train_ref``."""
    return fused_svgd_train_ref(theta, mu, nu, x, y, mask, w_t, step0, lr, prior_factor, counts,
                                hidden=hidden, wps=wps, bps=bps, n_steps=n_steps,
                                task_mll=functools.partial(bign_prior_mll_batch,
                                                           level_dtype=level_dtype))


@functools.lru_cache(maxsize=None)
def hidden_widths(hidden, device):
    """[2L] int32: the mean net's hidden widths, then the kernel net's."""
    return torch.tensor(list(hidden) * 2, dtype=torch.int32, device=device)


def fused_svgd_bign_train(theta, mu, nu, x, y, mask, w_t, step0, lr, prior_factor, counts=None,
                          *, hidden, wps, bps, n_steps):
    """n_steps of PACOH-SVGD on flat particles theta [K, P] and Adam moments
    mu, nu [K, P], all updated in place; the arguments of
    ``fused_svgd_kernel.fused_svgd_train``, for tasks of 9 <= N <= 256. The
    plain version for CPU tensors, the kernel for CUDA tensors."""
    hidden = tuple(int(h) for h in hidden)
    if n_steps < 1:
        raise ValueError(f"fused_svgd_bign: n_steps must be >= 1, got {n_steps}")
    if theta.device.type == "cpu":
        return fused_svgd_bign_train_ref(theta, mu, nu, x, y, mask, w_t, step0, lr, prior_factor,
                                         counts, hidden=hidden, wps=wps, bps=bps, n_steps=n_steps)
    operands = [("theta", theta, 2), ("mu", mu, 2), ("nu", nu, 2), ("x", x, 3), ("y", y, 2),
                ("mask", mask, 2), ("w_t", w_t, 1)]
    if counts is not None:
        operands.append(("counts", counts, 2))
    for name, t_, ndim in operands:
        cuda.check_operand(f"fused_svgd_bign {name}", t_, ndim)
        if t_.device != theta.device:
            raise ValueError(f"fused_svgd_bign {name}: on {t_.device}, theta on {theta.device}")
    k, p = theta.shape
    t, n, d = x.shape
    plan = svgd_bign_plan(k, t, n, d, hidden)
    if plan is None:
        raise ValueError(f"fused_svgd_bign: the kernel does not take K={k}, T={t}, N={n}, D={d}, "
                         f"hidden={hidden}")
    if (p != fused_prior(d, hidden, 1.0, 1.0).dim or mu.shape != theta.shape
            or nu.shape != theta.shape or y.shape != (t, n) or mask.shape != (t, n)
            or w_t.shape != (t,) or (counts is not None and counts.shape != (n_steps, t))):
        raise ValueError("fused_svgd_bign: operand shapes do not match theta [K, P] and "
                         "x [T, N, D]")
    blocks, spb, shared, threads = plan
    loc, scale, offs = _device_operands(d, hidden, float(wps), float(bps), theta.device)
    widths = hidden_widths(hidden, theta.device)

    def scratch(*shape):
        return torch.empty(*shape, dtype=theta.dtype, device=theta.device)

    gbuf, th_buf, d2 = scratch(k * t, p), scratch(2, k, p), scratch(k, k)
    act = None if shared == 2 else scratch(blocks, 2 * (n | 1) * sum(hidden))
    work = None if shared else scratch(blocks, n, n)
    launch("pacoh_fused_svgd_bign", theta, theta.data_ptr(), mu.data_ptr(), nu.data_ptr(),
           x.data_ptr(), y.data_ptr(), mask.data_ptr(), w_t.data_ptr(),
           None if counts is None else counts.data_ptr(), loc.data_ptr(), scale.data_ptr(),
           offs.data_ptr(), widths.data_ptr(), gbuf.data_ptr(),
           None if act is None else act.data_ptr(),
           None if work is None else work.data_ptr(), th_buf.data_ptr(), d2.data_ptr(),
           k, t, n, d, hidden[0], len(hidden), p, int(n_steps), blocks, spb, shared, threads,
           float(step0), float(lr), float(prior_factor))
    cuda.LAUNCHES["fused_svgd_bign"] += 1
    cuda.LAUNCHES["fused_svgd_bign_coresident"] += int(threads < THREADS)
    return theta, mu, nu


class FusedSVGDBigNTrainer(FusedSVGDTrainer):
    """``FusedSVGDTrainer`` for tasks of 9 <= N <= 256: the same host interface
    (task weights, count pages from the learner's draws, staircase launches,
    the caller's particles and moments updated in place), launching the
    big-N kernel."""

    train_fn = staticmethod(fused_svgd_bign_train)
