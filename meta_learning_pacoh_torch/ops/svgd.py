"""Stein variational gradient descent: kernels and the particle update (counterpart of meta_learning_pacoh_tpu/ops/svgd.py).

    phi = (K_XX @ score + grad_K) / K,  grad_K_i = -sum_j d/dx_i k(x_i, x_j)

The kernel gradient is analytic. The RBF kernel's median-heuristic bandwidth
takes the order statistic at rank K*K//2 of the pairwise squared distances,
the convention of the TPU's Stein kernel (JAX on the TPU), not the midpoint
average of ``jnp.median`` that the JAX package's plain path takes on the CPU.
"""

import math

import torch

from meta_learning_pacoh_torch import config
from meta_learning_pacoh_torch.ops.cuda.svgd_kernel import svgd_phi_fused, svgd_phi_ref
from meta_learning_pacoh_torch.ops.kernels import sq_dists


def rbf_phi(particles, score, bandwidth=None):
    """SVGD direction with the RBF kernel. particles, score [K, P] -> [K, P]."""
    if bandwidth is None:
        return svgd_phi_ref(particles, score)
    k = particles.shape[0]
    d2 = sq_dists(particles, particles)
    gamma = 1.0 / (1e-8 + 2.0 * bandwidth ** 2)
    k_xx = torch.exp(-gamma * d2)
    row_sum = torch.sum(k_xx, dim=1, keepdim=True)
    return (k_xx @ score + 2.0 * gamma * (particles * row_sum - k_xx @ particles)) / k


def imq_phi(particles, score, alpha=0.5, beta=-0.5, bandwidth=None):
    """SVGD direction with the IMQ kernel (alpha + sum_d diff_d^2 / h_d)^beta.

    The per-dimension bandwidth is the median (midpoint of the two middles,
    as numpy) over the strictly upper-triangular pairs / log(K+1).
    """
    k, p = particles.shape
    diffs = particles[:, None, :] - particles[None, :, :]  # [K, K, P]
    norm_sq = diffs ** 2
    if bandwidth is None:
        iu, ju = torch.triu_indices(k, k, offset=1, device=particles.device)
        h = torch.quantile(norm_sq[iu, ju, :], 0.5, dim=0) / math.log(k + 1)
    else:
        h = torch.full((p,), float(bandwidth), dtype=particles.dtype, device=particles.device)
    base = alpha + torch.sum(norm_sq / h, dim=-1)  # [K, K]
    k_xx = base ** beta
    w = beta * base ** (beta - 1.0)
    grad_k = -2.0 * torch.einsum("ij,ijd->id", w, diffs) / h
    return (k_xx @ score + grad_k) / k


def svgd_phi(particles, score, kernel="RBF", bandwidth=None):
    if kernel == "RBF":
        if bandwidth is None and config.kernels_enabled():
            return svgd_phi_fused(particles.contiguous(), score.contiguous())
        return rbf_phi(particles, score, bandwidth=bandwidth)
    if kernel == "IMQ":
        return imq_phi(particles, score, bandwidth=bandwidth)
    raise NotImplementedError(f"unknown SVGD kernel {kernel!r}")
