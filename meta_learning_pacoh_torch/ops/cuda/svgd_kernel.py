"""Stein transport kernel (csrc/svgd_phi.cu) and its plain version.

Replaces meta_learning_pacoh_tpu/ops/pallas/svgd_kernel.py (``svgd_phi_fused``,
the Pallas kernel ``_svgd_kernel``). The median of the K*K pairwise squared
distances is the order statistic at 0-based rank K*K//2, the upper middle
for an even count, which is what the TPU kernel's bisection converges to.
Neither ``torch.median`` (lower middle) nor ``jnp.median`` (mean of the
two) gives it. On the card the kernel is one block, bound by its own latency
at the slice's K=10, P=2372 (see the source).
"""

import math

import torch

from meta_learning_pacoh_torch.ops import cuda
from meta_learning_pacoh_torch.ops.cuda.build import launch
from meta_learning_pacoh_torch.ops.kernels import sq_dists

MAX_K = 32  # the kernel keeps K x K intermediates in shared memory


def median_upper(d2):
    """Order statistic of all entries of d2 [K, K] at 0-based rank K*K//2."""
    flat = d2.reshape(-1)
    return torch.kthvalue(flat, flat.numel() // 2 + 1).values


def svgd_phi_ref(x, s):
    """Plain PyTorch version: phi [K, P] for particles x and scores s [K, P]."""
    k = x.shape[0]
    d2 = sq_dists(x, x)
    h = median_upper(d2) / (2.0 * math.log(k + 1))
    gamma = 1.0 / (1e-8 + 2.0 * h)
    k_xx = torch.exp(-gamma * d2)
    row_sum = torch.sum(k_xx, dim=1, keepdim=True)
    return (k_xx @ s + 2.0 * gamma * (x * row_sum - k_xx @ x)) / k


def svgd_phi_fused(x, s):
    """phi for the RBF kernel with the median-heuristic bandwidth."""
    if x.device.type == "cpu":
        return svgd_phi_ref(x, s)
    cuda.check_operand("svgd_phi x", x, 2)
    cuda.check_operand("svgd_phi s", s, 2)
    k, p = x.shape
    if s.shape != x.shape or s.device != x.device:
        raise ValueError(f"svgd_phi: s {tuple(s.shape)} does not match x {tuple(x.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"svgd_phi: the kernel takes 1 <= K <= {MAX_K}, got {k}")
    phi = torch.empty_like(x)
    launch("pacoh_svgd_phi", x, x.data_ptr(), s.data_ptr(), phi.data_ptr(), k, p,
           math.log(k + 1))
    cuda.LAUNCHES["svgd_phi"] += 1
    return phi
