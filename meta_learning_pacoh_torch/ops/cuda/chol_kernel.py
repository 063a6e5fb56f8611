"""Batched Cholesky kernel (csrc/chol.cu) and its plain version.

Replaces the factor-only entry of meta_learning_pacoh_tpu/ops/pallas/
blocked_mll_kernel.py (``blocked_cholesky``, the Pallas kernel
``_chol_only_kernel``). Only the lower triangle of the input is read. There
is no jitter: a matrix whose factorization fails comes back all NaN, and
``ops.chol.safe_cholesky`` escalates around the call. On the card a matrix is
one block of 256 threads, factored in panels of 32 columns
(csrc/tiled_chol.cuh) with its lower triangle packed by rows in shared
memory up to ``CHOL_SHARED_MAX_N`` (two blocks an SM up to N=208), in place
in the output in device memory above.
"""

import torch

from meta_learning_pacoh_torch.ops import cuda
from meta_learning_pacoh_torch.ops.cuda.build import launch

CHOL_KERNEL_MIN_N = 65  # below: B5 for 32 <= N <= 64 (chol_small_kernel.py), as in the JAX package
CHOL_KERNEL_MAX_N = 512  # the kernel's limit and the TPU kernel's window
SMEM_BYTES = 232448  # shared memory one Hopper block can use
TILE = 32  # csrc/tiled_chol.cuh kTile: the columns of a panel


def _round4(x):
    return (x + 3) & ~3


def tiled_scratch_bytes(n, n_rows):
    """Shared-memory bytes of csrc/tiled_chol.cuh's scratch for an N x N
    system with n_rows rows (N + 1 with a border row): L11^T, a flag and the
    panel of TILE columns over the rows below the first tile."""
    return 4 * (TILE * TILE + 4 + TILE * _round4(max(n_rows - min(n, TILE), 1)))


def tiled_shared_bytes(n, n_rows):
    """Shared-memory bytes of a block of csrc/tiled_chol.cuh holding the
    packed triangle of an N x N system with n_rows rows: the scratch and the
    rows, row i padded to a multiple of 4 floats."""
    return tiled_scratch_bytes(n, n_rows) + 4 * sum(_round4(i + 1) for i in range(n_rows))


def chol_in_shared(n):
    """Whether the kernel holds an N x N matrix in shared memory (as
    csrc/chol.cu decides)."""
    return tiled_shared_bytes(n, n) <= SMEM_BYTES


CHOL_SHARED_MAX_N = max(n for n in range(1, CHOL_KERNEL_MAX_N + 1) if chol_in_shared(n))


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


def blocks_per_sm(entry, n, device):
    """Resident blocks per SM of a tiled kernel at this N, by
    cudaOccupancyMaxActiveBlocksPerMultiprocessor (entry: the C function)."""
    import ctypes

    blocks = ctypes.c_int(0)
    launch(entry, torch.empty(0, device=device), n, ctypes.addressof(blocks))
    return blocks.value


def chol_blocks_per_sm(n, device="cuda"):
    """Resident K4 blocks per SM at this N."""
    return blocks_per_sm("pacoh_chol_blocks_per_sm", n, device)
