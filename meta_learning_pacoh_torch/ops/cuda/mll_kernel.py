"""Batched GP marginal-likelihood core (csrc/mll.cu) and its plain version.

Replaces meta_learning_pacoh_tpu/ops/pallas/mll_kernel.py (``mll_quad_logdet``,
the Pallas kernels ``_mll_fwd_kernel`` and ``_mll_bwd_kernel``). For B
independent systems Kn [B, N, N] (noise already on the diagonal) and
residuals r [B, N]:

    quad = r^T Kn^{-1} r,  logdet = log |Kn|

with the factorization's jitter escalated per system through (0, 1e-4, 1e-2),
and the closed-form backward dKn = gl W^T W - gq alpha alpha^T,
dr = 2 gq alpha (W = L^{-1}, alpha = L^{-T} z). On the card each kernel
gives a system one warp, a block of its own: the forward its rows in
registers, the backward a column of W a lane in registers (see the source).
"""

import torch

from meta_learning_pacoh_torch.ops import cuda
from meta_learning_pacoh_torch.ops.cuda.build import launch
from meta_learning_pacoh_torch.ops.cuda.chol_kernel import cholesky_ref, diag_ok

MLL_KERNEL_MIN_N = 9  # below: the unrolled expressions (ops/chol.py)
MLL_KERNEL_MAX_N = 48  # above: the blocked MLL kernels B4 for 49 <= N <= 512 (ops/gp.py)
MAX_N = 64  # what the kernels take: at most two rows (or W columns) a lane
JITTERS = (0.0, 1e-4, 1e-2)


def mll_fwd_ref(kn, r):
    """Plain forward: (quad [B], logdet [B], L [B, N, N], z [B, N])."""
    eye = torch.eye(kn.shape[-1], dtype=kn.dtype, device=kn.device)
    L = cholesky_ref(kn)
    ok = diag_ok(L)
    if not bool(torch.all(ok)):
        L1 = cholesky_ref(kn + JITTERS[1] * eye)
        L2 = cholesky_ref(kn + JITTERS[2] * eye)
        esc = torch.where(diag_ok(L1)[:, None, None], L1, L2)
        L = torch.where(ok[:, None, None], L, esc)
    z = torch.linalg.solve_triangular(L, r[..., None], upper=False)[..., 0]
    quad = torch.sum(z * z, dim=-1)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    return quad, logdet, L, z


def mll_bwd_ref(L, z, gq, gl):
    """Plain backward: (dKn [B, N, N], dr [B, N])."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    alpha = torch.linalg.solve_triangular(L.mT, z[..., None], upper=True)[..., 0]
    W = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    kinv = W.mT @ W
    outer = alpha[:, :, None] * alpha[:, None, :]
    dkn = gl[:, None, None] * kinv - gq[:, None, None] * outer
    return dkn, 2.0 * gq[:, None] * alpha


def _check_n(n):
    if not 1 <= n <= MAX_N:
        raise ValueError(f"mll kernel: takes 1 <= N <= {MAX_N}, got {n}")


def mll_fwd(kn, r):
    """Forward wrapper: the kernel for CUDA tensors, the plain version on the CPU."""
    if kn.device.type == "cpu":
        return mll_fwd_ref(kn, r)
    cuda.check_operand("mll kn", kn, 3)
    cuda.check_operand("mll r", r, 2)
    b, n = kn.shape[0], kn.shape[-1]
    _check_n(n)
    if kn.shape != (b, n, n) or r.shape != (b, n) or r.device != kn.device:
        raise ValueError(f"mll: kn {tuple(kn.shape)} and r {tuple(r.shape)} do not match")
    quad = torch.empty(b, dtype=kn.dtype, device=kn.device)
    logdet = torch.empty_like(quad)
    L = torch.empty_like(kn)
    z = torch.empty_like(r)
    launch("pacoh_mll_fwd", kn, kn.data_ptr(), r.data_ptr(), quad.data_ptr(),
           logdet.data_ptr(), L.data_ptr(), z.data_ptr(), b, n)
    cuda.LAUNCHES["mll_fwd"] += 1
    return quad, logdet, L, z


def mll_bwd(L, z, gq, gl):
    """Backward wrapper: the kernel for CUDA tensors, the plain version on the CPU."""
    if L.device.type == "cpu":
        return mll_bwd_ref(L, z, gq, gl)
    for name, t, ndim in (("L", L, 3), ("z", z, 2), ("gq", gq, 1), ("gl", gl, 1)):
        cuda.check_operand(f"mll bwd {name}", t, ndim)
    b, n = L.shape[0], L.shape[-1]
    _check_n(n)
    if z.shape != (b, n) or gq.shape != (b,) or gl.shape != (b,):
        raise ValueError("mll bwd: operand shapes do not match L")
    dkn = torch.empty_like(L)
    dr = torch.empty_like(z)
    launch("pacoh_mll_bwd", L, L.data_ptr(), z.data_ptr(), gq.data_ptr(),
           gl.data_ptr(), dkn.data_ptr(), dr.data_ptr(), b, n)
    cuda.LAUNCHES["mll_bwd"] += 1
    return dkn, dr


class _QuadLogdet(torch.autograd.Function):
    """(quad, logdet) with the backward computed by ``bwd`` from (L, z)."""

    @staticmethod
    def forward(ctx, kn, r, fwd, bwd):
        quad, logdet, L, z = fwd(kn, r)
        ctx.save_for_backward(L, z)
        ctx.bwd = bwd
        return quad, logdet

    @staticmethod
    def backward(ctx, gq, gl):
        L, z = ctx.saved_tensors
        dkn, dr = ctx.bwd(L, z, gq.contiguous(), gl.contiguous())
        return dkn, dr, None, None


def mll_quad_logdet(kn, r):
    """(quad [B], logdet [B]) of B systems kn [B, N, N], r [B, N]: kernels K2/K3."""
    return _QuadLogdet.apply(kn, r, mll_fwd, mll_bwd)


def mll_quad_logdet_ref(kn, r):
    """The same function by the plain versions, on any device."""
    return _QuadLogdet.apply(kn, r, mll_fwd_ref, mll_bwd_ref)
