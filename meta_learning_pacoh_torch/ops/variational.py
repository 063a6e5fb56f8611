"""Variational-GP building blocks: Gaussian KL, expected log-likelihood, and
the sparse-GP predictive (counterpart of meta_learning_pacoh_tpu/ops/variational.py).

One unwhitened parameterisation, q(f) = N(m, L L^T) directly over the latent
function at the train or context points, on every path. Every function
takes leading batch dimensions (the JAX package vmaps its unbatched ones).
"""

import math

import torch

from meta_learning_pacoh_torch.ops.chol import (
    UNROLL_MAX_N,
    diag_ok,
    safe_cholesky,
    unrolled_cholesky,
    unrolled_solve_lower,
    unrolled_solve_lower_T,
    unrolled_solve_lower_mat,
)

_LOG_2PI = math.log(2.0 * math.pi)
KL_JITTERS = (1e-4, 1e-2)  # the escalation after the caller's jitter


def _kl_factorize(m0, L0, m1, K1, jitter):
    """(kl, L1, M, d) with L1 = chol(K1 + j I), the jitter j escalated per
    system on a detached copy (jitter, 1e-4, 1e-2), M = L1^-1 L0 and
    d = L1^-1 (m1 - m0); unrolled expressions for N <= 8, else
    ``safe_cholesky`` and triangular solves."""
    n = m0.shape[-1]
    if n <= UNROLL_MAX_N:
        eye = torch.eye(n, dtype=K1.dtype, device=K1.device)
        K_nd = K1.detach()
        jit = torch.full(K1.shape[:-2], KL_JITTERS[-1], dtype=K1.dtype, device=K1.device)
        for j in reversed((jitter,) + KL_JITTERS[:-1]):
            ok = diag_ok(unrolled_cholesky(K_nd + j * eye))
            jit = torch.where(ok, torch.full_like(jit, j), jit)
        L1 = unrolled_cholesky(K1 + jit[..., None, None] * eye)
        M = unrolled_solve_lower_mat(L1, L0)
        d = unrolled_solve_lower(L1, m1 - m0)
    else:
        L1 = safe_cholesky(K1, jitters=(jitter,) + KL_JITTERS)
        M = torch.linalg.solve_triangular(L1, L0, upper=False)
        d = torch.linalg.solve_triangular(L1, (m1 - m0)[..., None], upper=False)[..., 0]
    trace = torch.sum(M * M, dim=(-2, -1))
    quad = torch.sum(d * d, dim=-1)
    logdet1 = 2.0 * torch.sum(torch.log(torch.diagonal(L1, dim1=-2, dim2=-1)), dim=-1)
    logdet0 = 2.0 * torch.sum(
        torch.log(torch.abs(torch.diagonal(L0, dim1=-2, dim2=-1)) + 1e-12), dim=-1)
    kl = 0.5 * (trace + quad - n + logdet1 - logdet0)
    return kl, L1, M, d


def _solve_upper_from_lower(L1, B):
    """X with L1^T X = B, for L1 [..., N, N] lower and B [..., N, M]."""
    if L1.shape[-1] <= UNROLL_MAX_N:
        return unrolled_solve_lower_T(L1[..., None, :, :], B.mT).mT
    return torch.linalg.solve_triangular(L1.mT, B, upper=True)


class _GaussianKL(torch.autograd.Function):
    """KL(N(m0, L0 L0^T) || N(m1, K1)) with the closed-form backward of the
    JAX package's ``_gaussian_kl_chol_bwd``: with P = (K1 + j I)^-1 and
    d = m1 - m0,

        dKL/dm1 = P d = -dKL/dm0,  dKL/dK1 = 0.5 (P - (P L0)(P L0)^T - (P d)(P d)^T),
        dKL/dL0 = P L0 - diag(sign(l_ii) / (|l_ii| + 1e-12)),

    two triangular solves instead of autograd through the factorization and
    its jitter selection. Inputs share one batch shape."""

    @staticmethod
    def forward(ctx, m0, L0, m1, K1, jitter):
        kl, L1, M, d = _kl_factorize(m0, L0, m1, K1, jitter)
        ctx.save_for_backward(L1, M, d, torch.diagonal(L0, dim1=-2, dim2=-1))
        return kl

    @staticmethod
    def backward(ctx, g):
        L1, M, d, diag0 = ctx.saved_tensors
        n = L1.shape[-1]
        w = _solve_upper_from_lower(L1, d[..., None])[..., 0]  # P (m1 - m0)
        W = _solve_upper_from_lower(L1, M)  # P L0
        eye = torch.eye(n, dtype=L1.dtype, device=L1.device).expand(L1.shape)
        Linv = _solve_upper_from_lower(L1, eye)  # L1^-T
        P = Linv @ Linv.mT
        gm1 = g[..., None] * w
        gK1 = (0.5 * g)[..., None, None] * (P - W @ W.mT - w[..., :, None] * w[..., None, :])
        gL0 = g[..., None, None] * (W - torch.diag_embed(torch.sign(diag0)
                                                         / (torch.abs(diag0) + 1e-12)))
        return -gm1, gL0, gm1, gK1, None


def gaussian_kl_chol(m0, L0, m1, K1, jitter=1e-6):
    """KL( N(m0, L0 L0^T) || N(m1, K1) ): m0, m1 [..., N]; L0 [..., N, N]
    lower; K1 [..., N, N] PSD; the batch shapes broadcast. Returns [...]."""
    batch = torch.broadcast_shapes(m0.shape[:-1], L0.shape[:-2], m1.shape[:-1], K1.shape[:-2])
    n = m0.shape[-1]
    return _GaussianKL.apply(m0.expand(batch + (n,)), L0.expand(batch + (n, n)),
                             m1.expand(batch + (n,)), K1.expand(batch + (n, n)), float(jitter))


def expected_log_prob_gaussian(y, f_mean, f_var, noise_var):
    """E_{f ~ N(f_mean, f_var)}[ log N(y | f, noise_var) ], elementwise."""
    return -0.5 * (((y - f_mean) ** 2 + f_var) / noise_var + torch.log(noise_var) + _LOG_2PI)


def svgp_predict(q_mean, q_chol, mean_c, K_cc, K_ct, mean_t, K_tt, jitter=1e-6):
    """Predictive q(f*) from a variational posterior at the context points.

    q(f_c) = N(q_mean, q_chol q_chol^T); prior mean and covariance (mean_c,
    K_cc) at the context, (mean_t, K_tt) at the test points, cross K_ct
    [..., Nc, Nt]:

        A      = K_cc^-1 K_ct
        mean*  = mean_t + A^T (q_mean - mean_c)
        cov*   = K_tt - K_tc K_cc^-1 K_ct + A^T S A
    """
    L = safe_cholesky(K_cc, jitters=(jitter,) + KL_JITTERS)
    A = torch.cholesky_solve(K_ct, L)
    post_mean = mean_t + (A.mT @ (q_mean - mean_c)[..., None])[..., 0]
    SA = torch.tril(q_chol).mT @ A
    V = torch.linalg.solve_triangular(L, K_ct, upper=False)
    post_cov = K_tt - V.mT @ V + SA.mT @ SA
    return post_mean, post_cov
