"""Stein variational gradient descent: kernels and the particle update (counterpart of meta_learning_pacoh_tpu/ops/svgd.py).

    phi = (K_XX @ score + grad_K) / K,  grad_K_i = -sum_j d/dx_i k(x_i, x_j)

Particles and scores are [K, P], or [S, K, P] for S stacked fits (seeds or
trials), each system transported on its own; a numeric bandwidth is a
number or a tensor [S], one value a system.

The kernel gradient is analytic. The RBF kernel's median-heuristic bandwidth
takes the order statistic at rank K*K//2 of the pairwise squared distances,
the convention of the TPU's Stein kernel (JAX on the TPU), not the midpoint
average of ``jnp.median`` that the JAX package's plain path takes on the CPU.
"""

import math

import torch

from meta_learning_pacoh_torch import config
from meta_learning_pacoh_torch.ops.cuda.svgd_kernel import svgd_phi_fused, svgd_phi_ref
from meta_learning_pacoh_torch.ops.kernels import per_seed, sq_dists


def rbf_median_gamma(d2):
    """gamma = 1 / (1e-8 + 2h), h = median(d2) / (2 log(K + 1)), d2 [K, K].

    The median is ``jnp.median``'s, the JAX function's: the mean of the two
    middle values of the K*K distances when K*K is even. ``rbf_phi`` and the
    Stein kernel K1 do not call it: they keep the TPU kernel's upper middle,
    the order statistic at rank K*K//2 (see the top of this module).
    """
    median = torch.quantile(d2.reshape(-1), 0.5, interpolation="midpoint")
    h = median / (2.0 * math.log(d2.shape[0] + 1))
    return 1.0 / (1e-8 + 2.0 * h)


def rbf_phi(particles, score, bandwidth=None):
    """SVGD direction with the RBF kernel. particles, score [..., K, P] -> [..., K, P]."""
    if bandwidth is None:
        return svgd_phi_ref(particles, score)
    k = particles.shape[-2]
    d2 = sq_dists(particles, particles)
    gamma = 1.0 / (1e-8 + 2.0 * per_seed(bandwidth, d2.dim()) ** 2)
    k_xx = torch.exp(-gamma * d2)
    row_sum = torch.sum(k_xx, dim=-1, keepdim=True)
    return (k_xx @ score + 2.0 * gamma * (particles * row_sum - k_xx @ particles)) / k


def imq_phi(particles, score, alpha=0.5, beta=-0.5, bandwidth=None):
    """SVGD direction with the IMQ kernel (alpha + sum_d diff_d^2 / h_d)^beta.

    The per-dimension bandwidth is the median (midpoint of the two middles,
    as numpy) over the strictly upper-triangular pairs / log(K+1).
    """
    k, p = particles.shape[-2:]
    diffs = particles[..., :, None, :] - particles[..., None, :, :]  # [..., K, K, P]
    norm_sq = diffs ** 2
    if bandwidth is None:
        iu, ju = torch.triu_indices(k, k, offset=1, device=particles.device)
        h = torch.quantile(norm_sq[..., iu, ju, :], 0.5, dim=-2) / math.log(k + 1)
    elif isinstance(bandwidth, torch.Tensor):
        h = bandwidth.to(particles.dtype)[:, None].expand(-1, p)
    else:
        h = torch.full((p,), float(bandwidth), dtype=particles.dtype, device=particles.device)
    base = alpha + torch.sum(norm_sq / h[..., None, None, :], dim=-1)  # [..., K, K]
    k_xx = base ** beta
    w = beta * base ** (beta - 1.0)
    grad_k = -2.0 * torch.einsum("...ij,...ijd->...id", w, diffs) / h[..., None, :]
    return (k_xx @ score + grad_k) / k


def svgd_phi(particles, score, kernel="RBF", bandwidth=None):
    if kernel == "RBF":
        if bandwidth is None and config.kernels_enabled():
            return svgd_phi_fused(particles.contiguous(), score.contiguous())
        return rbf_phi(particles, score, bandwidth=bandwidth)
    if kernel == "IMQ":
        return imq_phi(particles, score, bandwidth=bandwidth)
    raise NotImplementedError(f"unknown SVGD kernel {kernel!r}")
