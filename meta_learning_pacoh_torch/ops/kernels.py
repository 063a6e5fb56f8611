"""Covariance-kernel primitives (counterpart of meta_learning_pacoh_tpu/ops/kernels.py).

    k(x1, x2) = outputscale * exp(-0.5 * sum_d ((x1_d - x2_d) / ls_d)^2)

Shapes broadcast over any leading batch dimensions.
"""

import torch


def sq_dists(x1, x2):
    """Pairwise squared distances by the |a|^2 + |b|^2 - 2ab expansion.

    x1 [..., N, D], x2 [..., M, D] -> [..., N, M], clamped at 0.
    """
    x1_sq = torch.sum(x1 * x1, dim=-1)[..., :, None]
    x2_sq = torch.sum(x2 * x2, dim=-1)[..., None, :]
    cross = x1 @ x2.transpose(-1, -2)
    return torch.clamp(x1_sq + x2_sq - 2.0 * cross, min=0.0)


def rbf_ard(x1, x2, lengthscale, outputscale=1.0):
    """ARD squared-exponential kernel.

    x1 [..., N, D], x2 [..., M, D], lengthscale [..., D] -> [..., N, M].
    """
    ls = lengthscale[..., None, :]
    return outputscale * torch.exp(-0.5 * sq_dists(x1 / ls, x2 / ls))
