"""Predictive-distribution containers (counterpart of meta_learning_pacoh_tpu/ops/distributions.py).

Affine un-normalisation of predictive densities and equal-weight mixtures
over particles, with the mean, stddev, log_prob and cdf that ``predict`` and
``eval`` need. ``icdf`` (for ``confidence_intervals``) is not ported yet.
"""

import math

import torch

from meta_learning_pacoh_torch.ops.gp import mvn_log_prob

_LOG_2PI = math.log(2.0 * math.pi)


class Normal:
    """Elementwise Gaussian."""

    def __init__(self, loc, scale):
        self.loc = loc
        self.scale = scale

    @property
    def mean(self):
        return self.loc

    @property
    def stddev(self):
        return self.scale

    @property
    def variance(self):
        return self.scale ** 2

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -0.5 * (z ** 2 + _LOG_2PI) - torch.log(self.scale)

    def cdf(self, value):
        return 0.5 * (1.0 + torch.erf((value - self.loc) / (self.scale * math.sqrt(2.0))))


class MultivariateNormal:
    """Joint Gaussian, mean [..., N], cov [..., N, N]; log_prob is the joint density."""

    def __init__(self, mean, cov):
        self._mean = mean
        self.cov = cov

    @property
    def mean(self):
        return self._mean

    @property
    def variance(self):
        return torch.diagonal(self.cov, dim1=-2, dim2=-1)

    @property
    def stddev(self):
        return torch.sqrt(self.variance)

    def log_prob(self, value):
        return mvn_log_prob(value, self._mean, self.cov)


class AffineTransformed:
    """y = loc + scale * x for x ~ base, with scalar loc and positive scalar scale."""

    def __init__(self, base, loc, scale):
        self.base = base
        self.loc = float(loc)
        self.scale = float(scale)

    @property
    def mean(self):
        return self.loc + self.scale * self.base.mean

    @property
    def stddev(self):
        return self.scale * self.base.stddev

    @property
    def variance(self):
        return self.scale ** 2 * self.base.variance

    def log_prob(self, value):
        lp = self.base.log_prob((value - self.loc) / self.scale)
        if isinstance(self.base, MultivariateNormal):
            return lp - self.base.mean.shape[-1] * math.log(self.scale)
        return lp - math.log(self.scale)

    def cdf(self, value):
        return self.base.cdf((value - self.loc) / self.scale)


class EqualWeightedMixture:
    """Uniform mixture over the leading (component) axis of a batched distribution."""

    def __init__(self, base):
        self.base = base

    @property
    def num_components(self):
        return self.base.mean.shape[0]

    @property
    def mean(self):
        return torch.mean(self.base.mean, dim=0)

    @property
    def variance(self):
        means = self.base.mean
        var_between = torch.mean((means - means.mean(0)) ** 2, dim=0)
        return var_between + torch.mean(self.base.variance, dim=0)

    @property
    def stddev(self):
        return torch.sqrt(self.variance)

    def log_prob(self, value):
        return torch.logsumexp(self.base.log_prob(value), dim=0) - math.log(self.num_components)

    def cdf(self, value):
        return torch.mean(self.base.cdf(value), dim=0)
