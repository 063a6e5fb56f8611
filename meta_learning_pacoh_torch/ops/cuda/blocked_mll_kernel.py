"""Blocked GP marginal-likelihood core for 49 <= N <= 512 (csrc/blocked_mll.cu) and its plain version.

Replaces meta_learning_pacoh_tpu/ops/pallas/blocked_mll_kernel.py
(``blocked_mll_quad_logdet``, its custom VJP over the Pallas kernels
``_mll_fwd_kernel`` and ``_mll_bwd_kernel``). For B independent systems
Kn [B, N, N] (noise already on the diagonal) and residuals r [B, N]:

    quad = r^T Kn^{-1} r,  logdet = log |Kn|

with the jitter (0, 1e-4, 1e-2) escalated per system on the whole diagonal
(the first level whose factorization succeeds; the level is a constant to
the gradient), and the closed-form backward dKn = gl W^T W - gq alpha
alpha^T, dr = 2 gq alpha (W = L^{-1}, alpha = W^T z). The contract is the
one of the K2/K3 kernels (ops/cuda/mll_kernel.py), at larger N. On the card
each system is one block. The forward factors with the tiled design of
csrc/tiled_chol.cuh, r carried as the factor's border row (so z comes out of
the factorization), its packed triangle in shared memory up to
``SHARED_MAX_N`` and in device memory above; the backward inverts the factor
with csrc/tiled_inverse.cuh's 32-column panels (W = L^-1, alpha = W^T z,
K^-1 = W^T W in place) and writes dKn whole, its packed triangle in shared
memory up to ``BWD_SHARED_MAX_N`` and in place in its output above (see the
source).
"""

import torch

from meta_learning_pacoh_torch.ops import cuda
from meta_learning_pacoh_torch.ops.cuda.build import launch
from meta_learning_pacoh_torch.ops.cuda.chol_kernel import (
    SMEM_BYTES,
    blocks_per_sm,
    tiled_shared_bytes,
)
from meta_learning_pacoh_torch.ops.cuda.mll_kernel import (
    _QuadLogdet,
    mll_bwd_ref,
    mll_fwd_ref,
)

BLOCKED_MIN_N = 49  # below: the K2/K3 kernels
BLOCKED_MAX_N = 512  # the kernel's limit and the TPU kernel's window


def blocked_in_shared(n):
    """Whether the forward holds an N x N system and its border row in
    shared memory (as csrc/blocked_mll.cu decides)."""
    return tiled_shared_bytes(n, n + 1) <= SMEM_BYTES


def bwd_shared_bytes(n):
    """Shared memory of a backward block holding its packed triangle, as
    csrc/blocked_mll.cu lays it out: the tiled passes' scratch and the packed
    lower triangle of N rows (``tiled_shared_bytes``), z and alpha, and the
    16 diagonal tiles' log sums."""
    return tiled_shared_bytes(n, n) + 4 * (2 * ((n + 3) & ~3) + 16)


def blocked_bwd_in_shared(n):
    """Whether the backward holds its packed triangle in shared memory (as
    csrc/blocked_mll.cu decides)."""
    return bwd_shared_bytes(n) <= SMEM_BYTES


SHARED_MAX_N = max(n for n in range(1, BLOCKED_MAX_N + 1) if blocked_in_shared(n))
BWD_SHARED_MAX_N = max(n for n in range(1, BLOCKED_MAX_N + 1) if blocked_bwd_in_shared(n))


def blocked_fwd_blocks_per_sm(n, device="cuda"):
    """Resident forward blocks per SM at this N."""
    return blocks_per_sm("pacoh_blocked_mll_fwd_blocks_per_sm", n, device)


def blocked_bwd_blocks_per_sm(n, device="cuda"):
    """Resident backward blocks per SM at this N for a batch of more systems
    than the card has SMs (a smaller batch runs one block an SM)."""
    return blocks_per_sm("pacoh_blocked_mll_bwd_blocks_per_sm", n, device)


# The plain versions: those of K2/K3, whose contract this kernel keeps at any N
blocked_mll_fwd_ref = mll_fwd_ref
blocked_mll_bwd_ref = mll_bwd_ref


def _check(name, b, n, shapes):
    if not 1 <= n <= BLOCKED_MAX_N:
        raise ValueError(f"{name}: takes 1 <= N <= {BLOCKED_MAX_N}, got {n}")
    for t, want in shapes:
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)}, expected {want}")


def blocked_mll_fwd(kn, r):
    """Forward wrapper: the kernel for CUDA tensors, the plain version on the CPU."""
    if kn.device.type == "cpu":
        return blocked_mll_fwd_ref(kn, r)
    cuda.check_operand("blocked_mll kn", kn, 3)
    cuda.check_operand("blocked_mll r", r, 2)
    b, n = kn.shape[0], kn.shape[-1]
    _check("blocked_mll", b, n, ((kn, (b, n, n)), (r, (b, n))))
    if r.device != kn.device:
        raise ValueError("blocked_mll: kn and r on different devices")
    quad = torch.empty(b, dtype=kn.dtype, device=kn.device)
    logdet = torch.empty_like(quad)
    L = torch.empty_like(kn)
    z = torch.empty_like(r)
    launch("pacoh_blocked_mll_fwd", kn, kn.data_ptr(), r.data_ptr(), quad.data_ptr(),
           logdet.data_ptr(), L.data_ptr(), z.data_ptr(), b, n)
    cuda.LAUNCHES["blocked_fwd"] += 1
    return quad, logdet, L, z


def blocked_mll_bwd(L, z, gq, gl):
    """Backward wrapper: the kernel for CUDA tensors, the plain version on the CPU."""
    if L.device.type == "cpu":
        return blocked_mll_bwd_ref(L, z, gq, gl)
    for name, t, ndim in (("L", L, 3), ("z", z, 2), ("gq", gq, 1), ("gl", gl, 1)):
        cuda.check_operand(f"blocked_mll bwd {name}", t, ndim)
        if t.device != L.device:
            raise ValueError(f"blocked_mll bwd {name}: on {t.device}, L on {L.device}")
    b, n = L.shape[0], L.shape[-1]
    _check("blocked_mll bwd", b, n, ((L, (b, n, n)), (z, (b, n)), (gq, (b,)), (gl, (b,))))
    dkn = torch.empty_like(L)
    dr = torch.empty_like(z)
    launch("pacoh_blocked_mll_bwd", L, L.data_ptr(), z.data_ptr(), gq.data_ptr(),
           gl.data_ptr(), dkn.data_ptr(), dr.data_ptr(), b, n)
    cuda.LAUNCHES["blocked_bwd"] += 1
    return dkn, dr


def blocked_mll_quad_logdet(kn, r):
    """(quad [B], logdet [B]) of B systems kn [B, N, N], r [B, N]: the B4 kernels."""
    return _QuadLogdet.apply(kn, r, blocked_mll_fwd, blocked_mll_bwd)


def blocked_mll_quad_logdet_ref(kn, r):
    """The same function by the plain versions, on any device."""
    return _QuadLogdet.apply(kn, r, blocked_mll_fwd_ref, blocked_mll_bwd_ref)
