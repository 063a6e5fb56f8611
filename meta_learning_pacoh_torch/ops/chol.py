"""Differentiable Cholesky with kernel dispatch (counterpart of meta_learning_pacoh_tpu/ops/chol.py).

``cholesky(A)`` is the entry point the GP engine uses. With the kernels on,
matrices of CHOL_KERNEL_MIN_N <= N <= CHOL_KERNEL_MAX_N go to the batched
Cholesky kernel (ops/cuda/chol_kernel.py, the counterpart of the TPU's
``blocked_cholesky``); other sizes go to ``torch.linalg``, as the JAX
package left them to XLA. A failed factorization is all NaN, never an
exception, so ``safe_cholesky`` can test its trial factors. The backward is
Murray's (2016) two triangular solves, as in the JAX package.
"""

import torch

from meta_learning_pacoh_torch import config
from meta_learning_pacoh_torch.ops.cuda.chol_kernel import (
    CHOL_KERNEL_MAX_N,
    CHOL_KERNEL_MIN_N,
    cholesky_fused,
    cholesky_ref,
    diag_ok,
)


def _cholesky_impl(a):
    n = a.shape[-1]
    if (config.kernels_enabled() and CHOL_KERNEL_MIN_N <= n <= CHOL_KERNEL_MAX_N
            and a.dtype == torch.float32):
        flat = a.reshape(-1, n, n).contiguous()
        return cholesky_fused(flat).reshape(a.shape)
    return cholesky_ref(a)


def _phi(x):
    """Lower triangle with halved diagonal."""
    return torch.tril(x) - 0.5 * torch.diag_embed(torch.diagonal(x, dim1=-2, dim2=-1))


class _Cholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        L = _cholesky_impl(a)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, L_bar):
        # A_bar = L^{-T} Phi(L^T L_bar)_sym L^{-1}
        (L,) = ctx.saved_tensors
        P = _phi(L.mT @ L_bar)
        S = 0.5 * (P + P.mT)
        X = torch.linalg.solve_triangular(L.mT, S, upper=True)
        return torch.linalg.solve_triangular(L.mT, X.mT, upper=True).mT


def cholesky(a):
    """Lower-triangular Cholesky factor of PSD matrices [..., N, N]."""
    return _Cholesky.apply(a)


# Fully unrolled factorization for tiny N: a handful of elementwise ops on
# the batch instead of a library factorization per call. Autograd flows
# through the expressions.
UNROLL_MAX_N = 8


def unrolled_cholesky(a):
    """Cholesky of [..., N, N] for small static N (Banachiewicz order)."""
    n = a.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    zero = torch.zeros_like(a[..., 0, 0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)], dim=-1)
            for i in range(n)]
    return torch.stack(rows, dim=-2)


def unrolled_solve_lower(L, b):
    """Solve L x = b (L [..., N, N] lower, b [..., N])."""
    n = b.shape[-1]
    x = []
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * x[k]
        x.append(s / L[..., i, i])
    return torch.stack(x, dim=-1)


def unrolled_solve_lower_T(L, b):
    """Solve L^T x = b (back substitution on the lower factor)."""
    n = b.shape[-1]
    x = [None] * n
    for i in reversed(range(n)):
        s = b[..., i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)


def unrolled_solve_lower_mat(L, B):
    """Solve L X = B for L [..., N, N] and B [..., N, M]."""
    return unrolled_solve_lower(L[..., None, :, :], B.mT).mT


def safe_cholesky(K, jitters=(1e-6, 1e-4, 1e-2), relative=False):
    """Cholesky with diagonal jitter escalated per matrix.

    The jitter is chosen on a detached copy, so the chosen level is a
    constant to autograd and no NaN of a failed trial reaches the backward;
    the result is one clean factorization at that level. relative=True
    scales the levels by the mean of the matrix's diagonal.
    """
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    K_nd = K.detach()
    if relative:
        scale = torch.diagonal(K_nd, dim1=-2, dim2=-1).mean(-1).clamp_min(1e-12)
    else:
        scale = torch.ones(K.shape[:-2], dtype=K.dtype, device=K.device)
    scale = scale[..., None, None]
    jitter = torch.full(K.shape[:-2], jitters[-1], dtype=K.dtype, device=K.device)
    for j in reversed(jitters[:-1]):
        ok = diag_ok(_cholesky_impl(K_nd + j * scale * eye))
        jitter = torch.where(ok, torch.full_like(jitter, j), jitter)
    return cholesky(K + jitter[..., None, None] * scale * eye)
