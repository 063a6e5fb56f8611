"""Big-N fused PACOH-VI training kernel (csrc/fused_vi_bign.cu), its plain version, and its trainer.

Replaces meta_learning_pacoh_tpu/ops/pallas/fused_vi_bign_kernel.py
(``fused_vi_bign_train_packed``, the Pallas kernel of ``_make_kernel``,
``vi_bign_fits`` and ``FusedVIBigNTrainer``): the sibling of the N <= 8
kernel (ops/cuda/fused_vi_kernel.py) for tasks of 9 <= N <= 256 points. One
launch runs ``n_steps`` PACOH-VI iterations of the diagonal Gaussian
hyper-posterior (loc, log_scale) on the learner's flat ``[P]`` state, with
the N <= 8 kernel's noise pages, count pages, constants, loss and Adam; the
per-(sample, task) GP algebra is the big-N score section of
csrc/bign_score.cuh, shared with the big-N SVGD kernel.

The jitter rule is the big-N kernels' (``fused_map_bign_kernel.
real_rows_mll``): on the real rows' diagonal only. In a ragged task that
escalates, the loss differs from the general step's (``neg_elbo`` through
``gp_prior_mll_batch``) by the padded rows' log(1 + jitter) in the
log-determinant; the gradients agree. The plain version here follows the
kernel.
"""

import functools

import torch

from meta_learning_pacoh_torch.ops import cuda
from meta_learning_pacoh_torch.ops.cuda.build import launch
from meta_learning_pacoh_torch.ops.cuda.fused_svgd_bign_kernel import (
    MAX_N,
    MIN_N,
    act_bytes,
    bign_prior_mll_batch,
    hidden_widths,
    matrix_bytes,
    systems_plan,
    vector_bytes,
)
from meta_learning_pacoh_torch.ops.cuda.fused_svgd_kernel import _device_operands, fused_prior
from meta_learning_pacoh_torch.ops.cuda.fused_vi_kernel import (
    MAX_S,
    FusedVITrainer,
    fused_vi_train_ref,
    prior_constants,
)


def smem_bytes(n, d, p, shared, hidden=()):
    """Shared memory of one block, as csrc/fused_vi_bign.cu lays it out: the
    tiled matrix's area, one sample, the task's rows and per-point vectors,
    a block sum's partials and, when ``shared`` is 2, the activations
    (``fused_svgd_bign_kernel.matrix_bytes``, ``vector_bytes``,
    ``act_bytes``)."""
    return (matrix_bytes(n, shared) + vector_bytes(n, d) + 4 * (p + 32)
            + act_bytes(n, hidden, shared))


def vi_bign_plan(s, t, n, d, hidden):
    """(blocks, systems a block, placement in shared memory) of the kernel at
    this configuration, or None where it does not take it: NN mean and NN
    kernel nets of one hidden width (feature dim 1), 1 <= S <= 32 samples,
    9 <= N <= 256, any T; the G = S T systems as ``fused_svgd_bign_kernel.
    systems_plan`` places them, the device scratch being the systems'
    partial gradients and values [G, P + 1] and, where they do not fit
    shared memory, the activations and the matrices. Where the learners take
    it is ``fused_svgd_bign_kernel.bign_wins``."""
    hidden = tuple(hidden)
    if not (1 <= s <= MAX_S and t >= 1 and d >= 1 and MIN_N <= n <= MAX_N
            and len(hidden) >= 1 and len(set(hidden)) == 1):
        return None
    p = fused_prior(d, hidden, 1.0, 1.0).dim
    g = s * t
    return systems_plan(
        g, n, lambda shared: smem_bytes(n, d, p, shared, hidden),
        lambda blocks, shared: (g * (p + 1) + s + 1
                                + (0 if shared == 2 else blocks * 2 * (n | 1) * sum(hidden))
                                + (0 if shared else blocks * n * n)))


def vi_bign_fits(s, t, n, d, hidden):
    """Whether the kernel takes this configuration (see ``vi_bign_plan``)."""
    return vi_bign_plan(s, t, n, d, hidden) is not None


def fused_vi_bign_train_ref(loc, lsc, m_loc, m_lsc, v_loc, v_lsc, x, y, mask, w_t, eps, step0,
                            lr, prior_factor, counts=None, *, hidden, wps, bps, mll_const,
                            n_steps, level_dtype=None):
    """Plain PyTorch version of ``fused_vi_bign_train``, updating in place:
    each step the negative ELBO with the task MLLs of
    ``fused_svgd_bign_kernel.bign_prior_mll_batch`` (torch.linalg, no
    kernel; its jitter levels chosen in ``level_dtype``), its gradients by
    autograd and the kernels' Adam, as ``fused_vi_train_ref``."""
    return fused_vi_train_ref(loc, lsc, m_loc, m_lsc, v_loc, v_lsc, x, y, mask, w_t, eps, step0,
                              lr, prior_factor, counts, hidden=hidden, wps=wps, bps=bps,
                              mll_const=mll_const, n_steps=n_steps,
                              task_mll=functools.partial(bign_prior_mll_batch,
                                                         level_dtype=level_dtype))


def fused_vi_bign_train(loc, lsc, m_loc, m_lsc, v_loc, v_lsc, x, y, mask, w_t, eps, step0, lr,
                        prior_factor, counts=None, *, hidden, wps, bps, mll_const, n_steps):
    """n_steps of PACOH-VI on the flat posterior loc, lsc [P] and their Adam
    moments, all updated in place; the arguments and results of
    ``fused_vi_kernel.fused_vi_train``, for tasks of 9 <= N <= 256. The plain
    version for CPU tensors, the kernel for CUDA tensors."""
    hidden = tuple(int(h) for h in hidden)
    if n_steps < 1:
        raise ValueError(f"fused_vi_bign: n_steps must be >= 1, got {n_steps}")
    if loc.device.type == "cpu":
        return fused_vi_bign_train_ref(loc, lsc, m_loc, m_lsc, v_loc, v_lsc, x, y, mask, w_t,
                                       eps, step0, lr, prior_factor, counts, hidden=hidden,
                                       wps=wps, bps=bps, mll_const=mll_const, n_steps=n_steps)
    state = (("loc", loc), ("lsc", lsc), ("m_loc", m_loc), ("m_lsc", m_lsc), ("v_loc", v_loc),
             ("v_lsc", v_lsc))
    operands = [(name, t_, 1) for name, t_ in state]
    operands += [("x", x, 3), ("y", y, 2), ("mask", mask, 2), ("w_t", w_t, 1), ("eps", eps, 3)]
    if counts is not None:
        operands.append(("counts", counts, 2))
    for name, t_, ndim in operands:
        cuda.check_operand(f"fused_vi_bign {name}", t_, ndim)
        if t_.device != loc.device:
            raise ValueError(f"fused_vi_bign {name}: on {t_.device}, loc on {loc.device}")
    s, p = eps.shape[1], eps.shape[2]
    t, n, d = x.shape
    plan = vi_bign_plan(s, t, n, d, hidden)
    if plan is None:
        raise ValueError(f"fused_vi_bign: the kernel does not take S={s}, T={t}, N={n}, D={d}, "
                         f"hidden={hidden}")
    if (p != fused_prior(d, hidden, 1.0, 1.0).dim or any(a.shape != (p,) for _, a in state)
            or eps.shape[0] != n_steps or y.shape != (t, n) or mask.shape != (t, n)
            or w_t.shape != (t,) or (counts is not None and counts.shape != (n_steps, t))):
        raise ValueError("fused_vi_bign: operand shapes do not match loc [P], eps [n_steps, S, P] "
                         "and x [T, N, D]")
    blocks, spb, shared = plan
    prior_loc, prior_scale, offs = _device_operands(d, hidden, float(wps), float(bps), loc.device)
    widths = hidden_widths(hidden, loc.device)
    lp_const, ent_const = prior_constants(d, hidden, float(wps), float(bps))

    def scratch(*shape):
        return torch.empty(*shape, dtype=loc.dtype, device=loc.device)

    gbuf, aux, loss = scratch(s * t, p + 1), scratch(s + 1), scratch(2)
    act = None if shared == 2 else scratch(blocks, 2 * (n | 1) * sum(hidden))
    work = None if shared else scratch(blocks, n, n)
    launch("pacoh_fused_vi_bign", loc, *(a.data_ptr() for _, a in state), x.data_ptr(),
           y.data_ptr(), mask.data_ptr(), w_t.data_ptr(),
           None if counts is None else counts.data_ptr(), eps.data_ptr(), prior_loc.data_ptr(),
           prior_scale.data_ptr(), offs.data_ptr(), widths.data_ptr(), gbuf.data_ptr(),
           None if act is None else act.data_ptr(), None if work is None else work.data_ptr(),
           aux.data_ptr(),
           loss.data_ptr(), s, t, n, d, hidden[0], len(hidden), p, int(n_steps), blocks, spb,
           shared, float(step0), float(lr), float(prior_factor), float(mll_const), lp_const,
           ent_const)
    cuda.LAUNCHES["fused_vi_bign"] += 1
    return loss[0], loss[1] / n_steps


class FusedVIBigNTrainer(FusedVITrainer):
    """``FusedVITrainer`` for tasks of 9 <= N <= 256: the same host interface
    (noise pages drawn on the card from (train seed, step), count pages, the
    MLL and prior constants, launches of at most 512 steps within a
    staircase step, the caller's state updated in place), launching the
    big-N kernel."""

    train_fn = staticmethod(fused_vi_bign_train)
