"""Plain PyTorch reference of PACOH-SVGD's first meta-training steps.

K particles of the flat GP-prior parameters start at draws of the
hyper-prior. A step takes the score of log(hyper-prior^prior_factor x
prod_t MLL_t^(m/(m + T))), with MLL_t the exact marginal likelihood of task
t's N points divided by N (m the tasks' harmonic-mean size), moves the
particles along the Stein direction of the RBF kernel whose bandwidth is the
median heuristic (the order statistic at rank K*K//2 of the K x K squared
distances, divided by 2 log(K + 1)), and takes an Adam step (b1 0.9, b2
0.999, eps 1e-8) on minus that direction.

The MLL adds the noise variance plus 1e-6 to the Gram matrix's diagonal and,
per system, the first jitter of (0, 1e-4, 1e-2) at which a float32 factor
succeeds: the rule of the configuration's kernels.
"""

import math

import torch

from benchmark.reference import gp

MLL_LEVELS = (0.0, 1e-4, 1e-2)


class Spec:
    """The learner's configuration, from a configuration file's keywords."""

    def __init__(self, kw, d):
        self.hidden = tuple(kw.get("mean_nn_layers", (32, 32)))
        self.k = int(kw.get("num_particles", 10))
        self.prior_factor = float(kw.get("prior_factor", 0.01))
        self.lr = float(kw.get("lr", 1e-3))
        self.wps = float(kw.get("weight_prior_std", 0.5))
        self.bps = float(kw.get("bias_prior_std", 3.0))
        self.lay, self.p = gp.layout(d, self.hidden, int(kw.get("feature_dim", 1)))


def initial_particles(spec, seed, loc, scale):
    """[K, P]: the hyper-prior's draws from a CPU torch generator seeded with
    the learner's seed, as the learner draws them."""
    eps = torch.randn((spec.k, spec.p), generator=torch.Generator().manual_seed(int(seed)))
    return loc + scale * eps.to(device=loc.device, dtype=loc.dtype)


def log_target(spec, theta, X, Y, loc, scale):
    """[K]: prior_factor log hyper-prior + m/(m + T) sum_t MLL_t / N."""
    k, (t, n, _) = theta.shape[0], X.shape
    leaves = {key: v.unsqueeze(1) for key, v in gp.unflatten(spec.lay, theta).items()}
    mean, gram = gp.prior_moments_at(leaves, X.expand(k, *X.shape), len(spec.hidden))
    noise = gp.softplus(leaves[("noise_raw",)])[:, :, None, None]
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    mll = gp.gauss_logpdf(Y.expand(k, t, n), mean, gram + (noise + 1e-6) * eye, MLL_LEVELS) / n
    z = (theta - loc) / scale
    log_prior = torch.sum(-0.5 * (z * z + gp.LOG_2PI) - torch.log(scale), dim=-1)
    return spec.prior_factor * log_prior + n / (n + t) * torch.sum(mll, dim=-1)


def stein_direction(theta, score):
    """phi [K, P] of the RBF kernel with the median-heuristic bandwidth."""
    k = theta.shape[0]
    diff = theta[:, None, :] - theta[None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    h = torch.sort(d2.reshape(-1)).values[k * k // 2] / (2.0 * math.log(k + 1))
    gamma = 1.0 / (1e-8 + 2.0 * h)
    kxx = torch.exp(-gamma * d2)
    return (kxx @ score + 2.0 * gamma * (theta * kxx.sum(-1, keepdim=True) - kxx @ theta)) / k


def adam(theta, m, v, g, t, lr):
    """One Adam step t (1-based) on gradient g, in place."""
    m.mul_(0.9).add_(0.1 * g)
    v.mul_(0.999).add_(0.001 * g * g)
    theta.sub_(lr * (m / (1.0 - 0.9 ** t)) / (torch.sqrt(v / (1.0 - 0.999 ** t)) + 1e-8))


def first_steps(spec, seed, X, Y, n_steps=3, dtype=torch.float64):
    """(theta0, the first step's gradient -phi, theta after n_steps), all
    [K, P], from the learner's seed on the normalised data X [T, N, D], Y [T, N]."""
    loc, scale = gp.hyper_prior(spec.lay, spec.p, spec.wps, spec.bps, X.device)
    loc, scale, X, Y = (a.to(dtype) for a in (loc, scale, X, Y))
    theta = initial_particles(spec, seed, loc, scale)
    theta0 = theta.clone()
    m, v = torch.zeros_like(theta), torch.zeros_like(theta)
    grad1 = None
    for step in range(1, n_steps + 1):
        part = theta.detach().requires_grad_(True)
        (score,) = torch.autograd.grad(log_target(spec, part, X, Y, loc, scale).sum(), part)
        with torch.no_grad():
            g = -stein_direction(theta, score)
            if grad1 is None:
                grad1 = g.clone()
            adam(theta, m, v, g, step, spec.lr)
    return theta0, grad1, theta
