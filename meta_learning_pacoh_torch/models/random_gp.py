"""GP prior as a random variable: hyper-prior and meta score (counterpart of meta_learning_pacoh_tpu/models/random_gp.py).

A particle is a flat float32 vector whose layout is the one
``jax.flatten_util.ravel_pytree`` gives the JAX package's parameter dict:
dict keys in sorted order at every level, each leaf in row-major order, so
a particle is the same numbers in both packages. At the default NN mean +
NN kernel 32 x 32 with feature_dim 1 that is
kernel_nn{b_0, b_1, b_out, w_0, w_1, w_out}, lengthscale_raw,
mean_nn{...}, noise_raw.

Hyper-prior blocks: lengthscale_raw ~ N(0, 1), noise_raw ~ N(-1, 1),
constant_mean ~ N(0, 1), NN weights ~ N(0, weight_prior_std), NN biases
~ N(0, bias_prior_std).

Meta score of a task batch:
  log p(params | batch) = prior_factor * log hyper_prior(params)
                          + m~/(m~ + m) * sum_t MLL_t(params)
with m~ the harmonic-mean task size, m the number of tasks, and each MLL_t
divided by its task size.
"""

import dataclasses
import math

import torch

from meta_learning_pacoh_torch.models.gp_base import (
    GPConfig,
    gp_gram,
    gp_hypers,
    gp_mean,
    init_gp_params,
)

_LOG_2PI = math.log(2.0 * math.pi)


def random_gp_config(input_dim, feature_dim=2, mean_module="NN", covar_module="NN",
                     mean_nn_layers=(32, 32), kernel_nn_layers=(32, 32)):
    """GPConfig of the RandomGP flavour: no outputscale, no noise floor,
    kaiming-tanh NN init."""
    return GPConfig(input_dim=input_dim, feature_dim=feature_dim,
                    mean_module=mean_module, covar_module=covar_module,
                    mean_nn_layers=tuple(mean_nn_layers),
                    kernel_nn_layers=tuple(kernel_nn_layers),
                    has_outputscale=False, noise_floor=0.0, init_scheme="kaiming_tanh")


def _flat_layout(tree):
    """[(path, shape, offset, size)] of the leaves of ``tree``, dict keys in
    sorted order at every level (the order of ``ravel_pytree``)."""
    layout, offset = [], 0

    def walk(node, path):
        nonlocal offset
        for key in sorted(node):
            leaf = node[key]
            if isinstance(leaf, dict):
                walk(leaf, path + (key,))
            else:
                layout.append((path + (key,), tuple(leaf.shape), offset, leaf.numel()))
                offset += leaf.numel()

    walk(tree, ())
    return layout


@dataclasses.dataclass
class HyperPrior:
    """Factorised Gaussian over the flat GP-prior parameter vector."""

    loc: torch.Tensor  # [P]
    scale: torch.Tensor  # [P]
    layout: list
    cfg: GPConfig

    @property
    def dim(self):
        return self.loc.shape[0]

    def slice_of(self, path):
        """Flat index range of the leaf at ``path``, e.g. ('kernel_nn', 'b_out')."""
        for p, _, offset, size in self.layout:
            if p == tuple(path):
                return slice(offset, offset + size)
        raise KeyError(path)

    def unravel(self, flat):
        """flat [..., P] -> nested dict of views, leaves [..., *shape]."""
        lead = flat.shape[:-1]
        params = {}
        for path, shape, offset, size in self.layout:
            node = params
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = flat[..., offset:offset + size].reshape(tuple(lead) + tuple(shape))
        return params

    def log_prob(self, flat):
        """flat [..., P] -> [...] (sum over the event dim)."""
        z = (flat - self.loc) / self.scale
        return torch.sum(-0.5 * (z * z + _LOG_2PI) - torch.log(self.scale), dim=-1)

    def sample(self, generator, sample_shape=()):
        """Draw from the prior with a CPU ``generator``, on the prior's device."""
        eps = torch.randn(tuple(sample_shape) + (self.dim,), generator=generator)
        return self.loc + self.scale * eps.to(self.loc.device)


def make_hyper_prior(cfg: GPConfig, weight_prior_std=1.0, bias_prior_std=3.0, device=None):
    """The block hyper-prior aligned with the flat parameter layout."""
    layout = _flat_layout(init_gp_params(cfg, torch.Generator()))
    total = layout[-1][2] + layout[-1][3]
    loc = torch.zeros(total, dtype=torch.float32)
    scale = torch.ones(total, dtype=torch.float32)
    for path, _, offset, size in layout:
        name = path[-1]
        block = slice(offset, offset + size)
        if name == "noise_raw":
            loc[block] = -1.0
        elif name.startswith("w_"):
            scale[block] = weight_prior_std
        elif name.startswith("b_"):
            scale[block] = bias_prior_std
    return HyperPrior(loc=loc.to(device), scale=scale.to(device), layout=layout, cfg=cfg)


def meta_log_prob(hyper_prior: HyperPrior, prior_factor, flat_particles, X, Y, mask=None):
    """PACOH generalised-Bayes score of K particles on a task batch.

    flat_particles [K, P]; X [T, N, D]; Y [T, N]; mask [T, N] or None.
    Returns [K]. The O(N^3) MLL cores of all K*T systems go through one
    ``gp_mll_batch`` call.
    """
    from meta_learning_pacoh_torch.ops.gp import gp_mll_batch

    if mask is None:
        mask = torch.ones_like(Y)
    cfg = hyper_prior.cfg
    k, t, n = flat_particles.shape[0], X.shape[0], Y.shape[-1]
    params = hyper_prior.unravel(flat_particles)
    x = X.expand(k, *X.shape)
    means = gp_mean(cfg, params, x)  # [K, T, N]
    grams = gp_gram(cfg, params, x)  # [K, T, N, N]
    _, _, noise = gp_hypers(cfg, params)  # [K]
    lls = gp_mll_batch(
        means.reshape(-1, n), grams.reshape(-1, n, n), Y.expand(k, t, n).reshape(-1, n),
        noise[:, None].expand(k, t).reshape(-1), mask.expand(k, t, n).reshape(-1, n))
    per_task = lls.reshape(k, t)

    sizes = torch.sum(mask, dim=-1)
    harmonic_mean = 1.0 / torch.mean(1.0 / sizes)
    pre_factor = harmonic_mean / (harmonic_mean + t)
    return prior_factor * hyper_prior.log_prob(flat_particles) + pre_factor * per_task.sum(-1)
