"""Masked exact-GP engine: marginal log-likelihood and posterior (counterpart of meta_learning_pacoh_tpu/ops/gp.py).

Plain functions of (mean vector, Gram matrix, targets) over any leading batch
dimensions. A padded point's Gram row and column become an identity row and
its residual zero, so it adds exactly 0 to the quadratic form and the
log-determinant. ``gp_mll`` returns the joint log-density divided by the
number of real points; ``noise_var`` is a variance.

The last tier, above the blocked kernels' window: inside a
``distributed_linalg`` context, systems of N >= min_n go through
parallel/dist_chol.py, each Gram matrix's block rows factored across the
ranks of a mesh axis. The context is an explicit, scoped opt-in (the
learners built with ``mesh=`` and large-N data open it around their loss).
It takes only a single task axis: ``gp_mll`` one [N, N] system and
``gp_mll_batch`` [B, N, N]. An operand with a particle or seed axis in
front keeps the single-device path, as the JAX package's refuses vmapped
operands (there shard_map cannot nest under vmap).
"""

import contextlib
import math

import torch

from meta_learning_pacoh_torch import config
from meta_learning_pacoh_torch.ops.chol import (
    UNROLL_MAX_N,
    cholesky,
    safe_cholesky,
    unrolled_cholesky,
    unrolled_solve_lower,
    unrolled_solve_lower_T,
    unrolled_solve_lower_mat,
)
from meta_learning_pacoh_torch.ops.cuda.blocked_mll_kernel import (
    BLOCKED_MAX_N,
    BLOCKED_MIN_N,
    blocked_mll_quad_logdet,
)
from meta_learning_pacoh_torch.ops.cuda.chol_kernel import diag_ok
from meta_learning_pacoh_torch.ops.cuda.mll_kernel import (
    JITTERS as MLL_JITTERS,
    MLL_KERNEL_MAX_N,
    MLL_KERNEL_MIN_N,
    mll_quad_logdet,
)

_LOG_2PI = math.log(2.0 * math.pi)

_DIST_LINALG = None


@contextlib.contextmanager
def distributed_linalg(mesh, axis_name="task", block_size=128, min_n=None):
    """Route large-N Gram factorizations through the distributed tier.

    min_n: the smallest N to distribute (default BLOCKED_MAX_N + 1, just
    past the blocked kernels' window; tests pass smaller values). The
    context must be open while the loss is computed; the backward needs it
    no more (it keeps the mesh of its forward).
    """
    global _DIST_LINALG
    if min_n is None:
        min_n = BLOCKED_MAX_N + 1
    prev = _DIST_LINALG
    _DIST_LINALG = (mesh, axis_name, block_size, int(min_n))
    try:
        yield
    finally:
        _DIST_LINALG = prev


def _dispatch_ctx(K, system_dims):
    """The open distributed-linalg context if the Gram operand K, of
    ``system_dims`` dimensions where one task axis is allowed, takes it."""
    if _DIST_LINALG is None or K.shape[-1] < _DIST_LINALG[3] or K.dim() != system_dims:
        return None
    return _DIST_LINALG


def add_noise_masked(K, noise_var, mask=None, jitter=1e-6):
    """K [..., N, N] + (noise + jitter) I, padded rows/cols replaced by identity rows.

    noise_var broadcasts against K's batch shape; mask [..., N] is 1.0 for
    a real point and 0.0 for padding (None: all real).
    """
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    nv = torch.as_tensor(noise_var, dtype=K.dtype, device=K.device)
    if mask is None:
        return K + (nv + jitter)[..., None, None] * eye
    m2 = mask[..., :, None] * mask[..., None, :]
    diag = torch.where(mask > 0, nv[..., None] + jitter, torch.ones_like(mask))
    return K * m2 + diag[..., :, None] * eye


def _residual(mean, y, mask):
    r = y - mean
    if mask is None:
        return r, torch.full(y.shape[:-1], float(y.shape[-1]), dtype=y.dtype, device=y.device)
    return r * mask, torch.sum(mask, dim=-1)


def _mll(quad, logdet, n_eff):
    return -0.5 * (quad + logdet + n_eff * _LOG_2PI) / n_eff


def gp_mll(mean, K, y, noise_var, mask=None, jitter=1e-6):
    """Exact GP marginal log-likelihood / number of real points, by plain ops.

    mean, y [..., N]; K [..., N, N]; noise_var broadcast to [...]. The
    jitter (0, 1e-4, 1e-2) is escalated per system.
    """
    Kn = add_noise_masked(K, noise_var, mask, jitter)
    r, n_eff = _residual(mean, y, mask)
    n = y.shape[-1]
    dist = _dispatch_ctx(K, 2)
    if dist is not None:
        from meta_learning_pacoh_torch.parallel.dist_chol import distributed_gp_mll

        d_mesh, d_axis, d_block, _ = dist
        return distributed_gp_mll(torch.zeros_like(r), Kn, r, d_mesh, d_axis, d_block,
                                  n_eff=n_eff) / n_eff
    if n <= UNROLL_MAX_N:
        Kn_nd = Kn.detach()
        eye = torch.eye(n, dtype=Kn.dtype, device=Kn.device)
        jit = torch.full(Kn.shape[:-2], MLL_JITTERS[-1], dtype=Kn.dtype, device=Kn.device)
        for j in reversed(MLL_JITTERS[:-1]):
            ok = diag_ok(unrolled_cholesky(Kn_nd + j * eye))
            jit = torch.where(ok, torch.full_like(jit, j), jit)
        L = unrolled_cholesky(Kn + jit[..., None, None] * eye)
        z = unrolled_solve_lower(L, r)
    else:
        L = safe_cholesky(Kn, jitters=MLL_JITTERS)
        z = torch.linalg.solve_triangular(L, r[..., None], upper=False)[..., 0]
    quad = torch.sum(z * z, dim=-1)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    return _mll(quad, logdet, n_eff)


def gp_mll_batch(mean, K, y, noise_var, mask=None, jitter=1e-6):
    """Batched exact GP MLL / n over B systems.

    mean, y [B, N]; K [B, N, N]; noise_var [B] or scalar; mask [B, N].
    Dispatch, with the kernels on and float32: N <= 8 unrolled expressions;
    MLL_KERNEL_MIN_N <= N <= MLL_KERNEL_MAX_N the MLL kernels K2/K3,
    BLOCKED_MIN_N <= N <= BLOCKED_MAX_N the blocked MLL kernels B4 (each a
    launch per direction for the whole batch); otherwise ``gp_mll``. In a
    ``distributed_linalg`` context, [B, N, N] systems of N >= min_n go
    through the distributed tier, one task after another.
    """
    n = y.shape[-1]
    noise_b = torch.as_tensor(noise_var, dtype=y.dtype, device=y.device).expand(y.shape[:-1])
    dist = _dispatch_ctx(K, 3)
    if dist is not None:
        from meta_learning_pacoh_torch.parallel.dist_chol import distributed_gp_mll_batch

        d_mesh, d_axis, d_block, _ = dist
        Kn = add_noise_masked(K, noise_b, mask, jitter)
        r, n_eff = _residual(mean, y, mask)
        mlls = distributed_gp_mll_batch(torch.zeros_like(r), Kn, r, d_mesh, d_axis, d_block,
                                        n_eff=n_eff)
        return mlls / n_eff
    quad_logdet = None
    if config.kernels_enabled() and y.dtype == torch.float32:
        if MLL_KERNEL_MIN_N <= n <= MLL_KERNEL_MAX_N:
            quad_logdet = mll_quad_logdet
        elif BLOCKED_MIN_N <= n <= BLOCKED_MAX_N:
            quad_logdet = blocked_mll_quad_logdet
    if quad_logdet is None:
        return gp_mll(mean, K, y, noise_b, mask, jitter)
    Kn = add_noise_masked(K, noise_b, mask, jitter)
    r, n_eff = _residual(mean, y, mask)
    quad, logdet = quad_logdet(Kn.contiguous(), r.contiguous())
    return _mll(quad, logdet, n_eff)


def gp_posterior(mean_c, K_cc, K_ct, mean_t, K_tt, y_c, noise_var, mask_c=None, jitter=1e-6):
    """Exact GP posterior of the latent f at test points given context data.

    mean_c, y_c [..., Nc]; K_cc [..., Nc, Nc]; K_ct [..., Nc, Nt];
    mean_t [..., Nt]; K_tt [..., Nt, Nt] -> (mean [..., Nt], cov [..., Nt, Nt]).
    """
    Kn = add_noise_masked(K_cc, noise_var, mask_c, jitter)
    r = y_c - mean_c
    if mask_c is not None:
        r = r * mask_c
        K_ct = K_ct * mask_c[..., :, None]
    if y_c.shape[-1] <= UNROLL_MAX_N:
        L = unrolled_cholesky(Kn)
        alpha = unrolled_solve_lower_T(L, unrolled_solve_lower(L, r))
        V = unrolled_solve_lower_mat(L, K_ct)
    else:
        L = cholesky(Kn)
        alpha = torch.cholesky_solve(r[..., None], L)[..., 0]
        V = torch.linalg.solve_triangular(L, K_ct, upper=False)
    post_mean = mean_t + (K_ct.mT @ alpha[..., None])[..., 0]
    post_cov = K_tt - V.mT @ V
    return post_mean, post_cov


def mvn_log_prob(y, mean, cov, jitter=1e-6):
    """Joint log-density of y under N(mean, cov): y, mean [..., N]; cov [..., N, N].

    The jitter is relative to the diagonal and escalated up to 1x per
    matrix: a degenerate mixture component's predictive covariance can be
    indefinite by about 1e-2 of its scale in float32, and a smoothed finite
    density beats a NaN that poisons the whole logsumexp.
    """
    n = y.shape[-1]
    L = safe_cholesky(cov, jitters=(jitter, 1e-2, 1e-1, 1.0), relative=True)
    z = torch.linalg.solve_triangular(L, (y - mean)[..., None], upper=False)[..., 0]
    quad = torch.sum(z * z, dim=-1)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * (quad + logdet + n * _LOG_2PI)
