"""Covariance-kernel primitives (counterpart of meta_learning_pacoh_tpu/ops/kernels.py).

    k(x1, x2) = outputscale * exp(-0.5 * sum_d ((x1_d - x2_d) / ls_d)^2)

Shapes broadcast over any leading batch dimensions.
"""

import torch


def softplus(x):
    """log(1 + exp(x)) in the form jax.nn.softplus evaluates: max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def inv_softplus(y):
    """Inverse of softplus, for initialising raw parameters from constrained
    values: y itself above 20, else log(expm1(y)) with y clipped to [1e-8, 20]."""
    y = torch.as_tensor(y, dtype=torch.float32)
    return torch.where(y > 20.0, y, torch.log(torch.expm1(torch.clamp(y, 1e-8, 20.0))))


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


def rbf_ard_diag(x, lengthscale, outputscale=1.0):
    """Diagonal of rbf_ard(x, x, ...), the outputscale everywhere: x [..., N, D] -> [..., N]."""
    return torch.broadcast_to(torch.as_tensor(outputscale, dtype=x.dtype, device=x.device),
                              x.shape[:-1])


def per_seed(value, ndim):
    """A number, or a tensor [S] (one value a stacked fit: a seed or a trial)
    shaped to broadcast against [S, ...] of ``ndim`` dims; a 0-dim tensor
    stays as it is."""
    if isinstance(value, torch.Tensor) and value.dim() == 1:
        return value.reshape(-1, *(1,) * (ndim - 1))
    return value
