"""Predictive-distribution containers (counterpart of meta_learning_pacoh_tpu/ops/distributions.py).

Affine un-normalisation of predictive densities and equal-weight mixtures
over particles, with the mean, stddev, log_prob, cdf and icdf that
``predict``, ``eval`` and ``confidence_intervals`` need. A mixture's icdf is
found by bisection (ops/rootfind.py). The JAX module's other public
containers follow: a factorised Gaussian, an unnormalised density and a
concatenation of independent blocks.
"""

import math

import torch

from meta_learning_pacoh_torch.ops.gp import mvn_log_prob
from meta_learning_pacoh_torch.ops.rootfind import find_root_by_bounding

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

    def icdf(self, q):
        return self.loc + self.scale * math.sqrt(2.0) * torch.erfinv(2.0 * q - 1.0)


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

    def icdf(self, q):
        return self.loc + self.scale * self.base.icdf(q)


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

    def icdf(self, q, eps=1e-6):
        left = torch.full_like(q, -1e8)
        right = torch.full_like(q, 1e8)
        return find_root_by_bounding(lambda x: self.cdf(x) - q, left, right, eps=eps)


class FactorizedNormal:
    """Diagonal Gaussian whose log_prob sums over ``summation_axis``."""

    def __init__(self, loc, scale, summation_axis=-1):
        self._normal = Normal(loc, scale)
        self.summation_axis = summation_axis

    @property
    def mean(self):
        return self._normal.mean

    @property
    def stddev(self):
        return self._normal.stddev

    def log_prob(self, value):
        return torch.sum(self._normal.log_prob(value), dim=self.summation_axis)


class UnnormalizedExpDist:
    """Density proportional to exp(exponent_fn(value)); log_prob is the exponent."""

    def __init__(self, exponent_fn):
        self.exponent_fn = exponent_fn

    def log_prob(self, value):
        return self.exponent_fn(value)


class CatDist:
    """Concatenation of independent block distributions along the event dim.

    Each block has ``sample(generator, sample_shape) -> [..., d_i]`` and a
    ``log_prob`` over its own event dim. Where the JAX class takes a key and
    splits it a block each, ``sample`` takes one ``torch.Generator`` from
    which the blocks draw in order, first block first.
    """

    def __init__(self, dists, block_dims, reduce_event_dim=True):
        if len(dists) != len(block_dims):
            raise ValueError(f"{len(dists)} blocks but {len(block_dims)} block dims")
        self.dists = list(dists)
        self.block_dims = list(block_dims)
        self.reduce_event_dim = reduce_event_dim

    @property
    def event_dim(self):
        return sum(self.block_dims)

    def sample(self, generator, sample_shape=()):
        return torch.cat([d.sample(generator, sample_shape) for d in self.dists], dim=-1)

    def log_prob(self, value):
        """[...] summed over the blocks, or [n_blocks, ...] without ``reduce_event_dim``."""
        lps, idx = [], 0
        for d, n in zip(self.dists, self.block_dims):
            lps.append(d.log_prob(value[..., idx:idx + n]))
            idx += n
        stacked = torch.stack(lps, dim=0)
        return torch.sum(stacked, dim=0) if self.reduce_event_dim else stacked
