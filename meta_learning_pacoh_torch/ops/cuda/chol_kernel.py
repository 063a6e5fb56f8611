"""Batched Cholesky kernel (csrc/chol.cu) and its plain version.

Replaces the factor-only entry of meta_learning_pacoh_tpu/ops/pallas/
blocked_mll_kernel.py (``blocked_cholesky``, the Pallas kernel
``_chol_only_kernel``). Only the lower triangle of the input is read. There
is no jitter: a matrix whose factorization fails comes back all NaN, and
``ops.chol.safe_cholesky`` escalates around the call. On the card a matrix is
one block, held in shared memory up to N=232 and factored in panels of 8
columns (see the source).
"""

import torch

from meta_learning_pacoh_torch.ops import cuda
from meta_learning_pacoh_torch.ops.cuda.build import launch

CHOL_KERNEL_MIN_N = 65  # below: B5 for 32 <= N <= 64 (chol_small_kernel.py), as in the JAX package
CHOL_KERNEL_MAX_N = 512  # the kernel's limit and the TPU kernel's window


def diag_ok(L):
    """Per matrix of L [..., N, N]: is every diagonal entry finite and positive?"""
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    return torch.all(torch.isfinite(d) & (d > 0), dim=-1)


def cholesky_ref(a):
    """Plain version: lower factor of a [..., N, N], all NaN where it fails."""
    L, info = torch.linalg.cholesky_ex(a)
    return torch.where((info > 0)[..., None, None], torch.nan, L).contiguous()


def cholesky_fused(a):
    """Lower Cholesky factor of a [B, N, N]: the kernel for a CUDA tensor."""
    if a.device.type == "cpu":
        return cholesky_ref(a)
    cuda.check_operand("chol a", a, 3)
    b, n = a.shape[0], a.shape[-1]
    if a.shape[1] != n or not 1 <= n <= CHOL_KERNEL_MAX_N:
        raise ValueError(f"chol: takes [B, N, N] with N <= {CHOL_KERNEL_MAX_N}, "
                         f"got {tuple(a.shape)}")
    out = torch.empty_like(a)
    launch("pacoh_chol", a, a.data_ptr(), out.data_ptr(), b, n)
    cuda.LAUNCHES["chol"] += 1
    return out
