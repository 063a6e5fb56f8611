"""Evaluation metrics: average log-likelihood, RMSE, calibration (counterpart of meta_learning_pacoh_tpu/ops/metrics.py).

They take normalised-space predictive moments plus the y-normalisation
constants, so a whole batch of test tasks evaluates in one call.
"""

import math

import torch

from meta_learning_pacoh_torch.ops.gp import mvn_log_prob

_SQRT2 = math.sqrt(2.0)


def _normal_cdf(value, loc, scale):
    return 0.5 * (1.0 + torch.erf((value - loc) / (scale * _SQRT2)))


def calib_error_from_cdf(cdf_vals):
    """RMSE between empirical CDF frequencies and 20 levels in [0.05, 0.95]."""
    n = cdf_vals.shape[-1]
    levels = torch.linspace(0.05, 0.95, 20, dtype=cdf_vals.dtype, device=cdf_vals.device)
    emp_freq = torch.sum(cdf_vals[..., :, None] <= levels, dim=-2) / n
    return torch.sqrt(torch.mean((emp_freq - levels) ** 2, dim=-1))


def gp_eval_metrics(mean_n, cov_n, y, y_mean, y_std):
    """Metrics of one GP predictive.

    mean_n [..., N], cov_n [..., N, N] in normalised space; y [..., N] in
    original units. Returns (avg_ll, rmse, calib), each [...]; avg_ll is the
    joint log-density of the un-normalised predictive divided by N.
    """
    n = y.shape[-1]
    y_n = (y - y_mean) / y_std
    avg_ll = (mvn_log_prob(y_n, mean_n, cov_n) - n * math.log(y_std)) / n

    mean_o = y_mean + y_std * mean_n
    std_o = y_std * torch.sqrt(torch.diagonal(cov_n, dim1=-2, dim2=-1))
    rmse = torch.sqrt(torch.mean((mean_o - y) ** 2, dim=-1))
    calib = calib_error_from_cdf(_normal_cdf(y, mean_o, std_o))
    return avg_ll, rmse, calib


def mixture_eval_metrics(means_n, covs_n, y, y_mean, y_std):
    """Metrics of an equal-weight mixture of K GP predictives.

    means_n [K, ..., N], covs_n [K, ..., N, N] in normalised space; y [..., N]
    in original units. Returns (avg_ll, rmse, calib), each [...]. The
    mixture's joint LL is logsumexp_k(MVN_k) - log K, divided by N; the
    calibration uses the per-point mixture of Normals.
    """
    k, n = means_n.shape[0], means_n.shape[-1]
    y_n = (y - y_mean) / y_std
    joint_lps = mvn_log_prob(y_n, means_n, covs_n) - n * math.log(y_std)
    avg_ll = (torch.logsumexp(joint_lps, dim=0) - math.log(k)) / n

    means_o = y_mean + y_std * means_n
    stds_o = y_std * torch.sqrt(torch.diagonal(covs_n, dim1=-2, dim2=-1))
    rmse = torch.sqrt(torch.mean((means_o.mean(0) - y) ** 2, dim=-1))
    calib = calib_error_from_cdf(torch.mean(_normal_cdf(y, means_o, stds_o), dim=0))
    return avg_ll, rmse, calib
