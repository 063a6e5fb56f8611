"""Batched small-matrix Cholesky kernel B5 (csrc/chol_small.cu) and its plain version.

Replaces meta_learning_pacoh_tpu/ops/pallas/chol_kernel.py
(``cholesky_pallas``: ``_chol_single`` for one matrix, ``_chol_batched`` for
128 matrices at a time, lane-major). The JAX package reaches it only from an
explicitly batched call (``a.ndim >= 3``, its ops/chol.py) with
32 <= N <= 64; its vmapped callers never do. Every caller in the port is
batched, so ``ops.chol`` sends the whole window, CHOL_SMALL_MIN_N <= N <=
CHOL_SMALL_MAX_N, here: the predictive covariances of the evals (N=50 at
``sin_20``), the MLL and KL factorizations of tasks of 32-64 points. One
matrix is the B = 1 case of the same kernel.

The contract is K4's (ops/cuda/chol_kernel.py): input [B, N, N] float32, only
the lower triangle read, no jitter, and a matrix whose factorization fails
comes back all NaN, so ``ops.chol.safe_cholesky`` escalates around the call.
On the card one warp factors one matrix, its rows in registers, on the MLL
forward's register factorization (csrc/warp_chol.cuh; see the source).
"""

import torch

from meta_learning_pacoh_torch.ops import cuda
from meta_learning_pacoh_torch.ops.cuda.build import launch
from meta_learning_pacoh_torch.ops.cuda.chol_kernel import cholesky_ref

CHOL_SMALL_MIN_N = 32  # below: torch.linalg, as the JAX package leaves them to XLA
CHOL_SMALL_MAX_N = 64  # the kernel's limit and the TPU kernel's window


def cholesky_small(a):
    """Lower Cholesky factor of a [B, N, N], N <= 64: the kernel for a CUDA
    tensor, the plain version (``cholesky_ref``) for a CPU one."""
    if a.device.type == "cpu":
        return cholesky_ref(a)
    cuda.check_operand("chol_small a", a, 3)
    b, n = a.shape[0], a.shape[-1]
    if a.shape[1] != n or not 1 <= n <= CHOL_SMALL_MAX_N:
        raise ValueError(f"chol_small: takes [B, N, N] with N <= {CHOL_SMALL_MAX_N}, "
                         f"got {tuple(a.shape)}")
    out = torch.empty_like(a)
    if b > 0:
        launch("pacoh_chol_small", a, a.data_ptr(), out.data_ptr(), b, n)
        cuda.LAUNCHES["chol_small"] += 1
    return out
