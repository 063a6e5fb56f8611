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

The Gaussian hyper-posterior of PACOH-VI (and MLAP) and its helpers follow:
sampling takes its standard normals as an argument, so the fused path, the
general step and the tests can feed one set of noise.

Stacked fits (seeds or trials, ``parallel/seed_parallel.py``) give every
state tensor a leading axis S: particles [S, K, P], a posterior's leaves
[S, P]; the data [S, T, ...] (per seed) or [T, ...] (shared); a
hyperparameter such as prior_factor a number or a tensor [S].
"""

import dataclasses
import functools
import math

import torch

from meta_learning_pacoh_torch.models.gp_base import (
    GPConfig,
    gp_prior_mll,
    gp_prior_mll_batch,
    init_gp_params,
)
from meta_learning_pacoh_torch.ops.kernels import per_seed

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


def tree_layout(tree):
    """((path, shape, offset, size), ...) of the leaves of ``tree``, dict keys
    in sorted order at every level (the order of ``ravel_pytree``)."""
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
    return tuple(layout)


@functools.lru_cache(maxsize=None)
def flat_layout(cfg: GPConfig):
    """The flat layout of ``cfg``'s parameter dict."""
    return tree_layout(init_gp_params(cfg, torch.Generator()))


def layout_dim(layout):
    """P, the length of the flat vector."""
    return layout[-1][2] + layout[-1][3]


def layout_slice(layout, path):
    """Flat index range of the leaf at ``path``, e.g. ('kernel_nn', 'b_out')."""
    for p, _, offset, size in layout:
        if p == tuple(path):
            return slice(offset, offset + size)
    raise KeyError(path)


def unravel_flat(layout, flat):
    """flat [..., P] -> nested dict of views, leaves [..., *shape]. One split,
    so autograd takes one node for all the leaves' gradients."""
    lead = flat.shape[:-1]
    params = {}
    leaves = torch.split(flat, [size for _, _, _, size in layout], dim=-1)
    for (path, shape, _, _), leaf in zip(layout, leaves):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf.reshape(tuple(lead) + tuple(shape))
    return params


def ravel_flat(layout, params):
    """Nested dict of leaves [..., *shape] -> flat [..., P], the inverse of ``unravel_flat``."""
    leaves = []
    for path, shape, _, _ in layout:
        leaf = params
        for key in path:
            leaf = leaf[key]
        leaves.append(leaf.reshape(leaf.shape[:leaf.dim() - len(shape)] + (-1,)))
    return torch.cat(leaves, dim=-1)


@dataclasses.dataclass
class HyperPrior:
    """Factorised Gaussian over the flat GP-prior parameter vector."""

    loc: torch.Tensor  # [P]
    scale: torch.Tensor  # [P]
    layout: tuple
    cfg: GPConfig

    @property
    def dim(self):
        return self.loc.shape[0]

    def slice_of(self, path):
        return layout_slice(self.layout, path)

    def unravel(self, flat):
        return unravel_flat(self.layout, flat)

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
    layout = flat_layout(cfg)
    total = layout_dim(layout)
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


def task_mll_flat(hyper_prior: HyperPrior, flat_params, x, y, mask=None):
    """Exact MLL / n of one task under GP-prior parameters given as a flat
    vector: flat [P] -> a scalar ([K, P] -> [K]); x [N, D], y [N], mask [N]
    or None."""
    flat = flat_params.reshape(-1, flat_params.shape[-1])
    lls = gp_prior_mll(hyper_prior.cfg, hyper_prior.unravel(flat), x, y, mask=mask)
    return lls.reshape(flat_params.shape[:-1])


def meta_log_prob(hyper_prior: HyperPrior, prior_factor, flat_particles, X, Y, mask=None,
                  counts=None, task_mll=gp_prior_mll_batch, task_sizes=None, with_prior=True):
    """PACOH generalised-Bayes score of K particles on a task batch.

    flat_particles [K, P]; X [T, N, D]; Y [T, N]; mask [T, N] or None.
    Returns [K]; stacked, particles [S, K, P], data [S, T, ...] or shared,
    prior_factor a number or [S], counts [S, T] -> [S, K]. The task MLLs
    [..., K, T] come from ``task_mll``, a function of
    the arguments of ``gp_prior_mll_batch`` (the big-N fused kernels' plain
    versions pass their own jitter rule).

    counts [..., T] (optional): the count-weighted estimator of a sampled task
    batch. X, Y, mask are the full task set and counts holds each task's
    multiplicity in the sample (summing to the batch size). It equals
    gathering the sampled batch: the harmonic mean is taken over the sampled
    multiset, and a never-drawn task adds exactly 0 even if its MLL is NaN.

    A rank of a task-sharded mesh passes the full batch's shard of the
    tasks: ``task_sizes`` [T] the real-point counts of all T tasks (the
    harmonic mean and the task count are the whole batch's), and
    ``with_prior`` True on one rank only, so that the hyper-prior term is
    added once when the ranks' scores are summed.
    """
    if mask is None:
        mask = torch.ones_like(Y)
    t = X.shape[-3]
    per_task = task_mll(hyper_prior.cfg, hyper_prior.unravel(flat_particles),
                        X, Y, mask)  # [..., K, T]

    sizes = torch.sum(mask, dim=-1)
    if task_sizes is not None:
        sizes, t = task_sizes, task_sizes.shape[-1]
    if counts is None:
        harmonic_mean = 1.0 / torch.mean(1.0 / sizes, dim=-1)
        pre_factor = harmonic_mean / (harmonic_mean + t)
        task_sum = per_task.sum(-1)
    else:
        batch_n = torch.sum(counts, dim=-1)
        harmonic_mean = batch_n / torch.sum(counts / sizes, dim=-1)
        pre_factor = harmonic_mean / (harmonic_mean + batch_n)
        # a never-drawn task's MLL (maybe NaN) is replaced, not multiplied by 0
        counts = counts.unsqueeze(-2)
        task_sum = (counts * torch.where(counts > 0, per_task, 0.0)).sum(-1)
    data_term = per_seed(pre_factor, 2) * task_sum
    if not with_prior:
        return data_term
    return per_seed(prior_factor, 2) * hyper_prior.log_prob(flat_particles) + data_term



# --------------------------------------------------------------------------
# Gaussian hyper-posterior (PACOH-VI, MLAP): a dict {'loc' [P], 'log_scale'
# [P]} (diagonal) or {'loc' [P], 'tril_raw' [P, P]} (full covariance, the
# scale_tril's diagonal kept in log space: diagonal = exp(diag(tril_raw))).
# --------------------------------------------------------------------------


def init_posterior(generator, dim, cov_type="diag", init_std=0.1, device=None):
    """Initial posterior drawn with a CPU ``generator``, moved to ``device``."""
    loc = init_std * torch.randn(dim, generator=generator)
    if cov_type == "diag":
        post = {"loc": loc,
                "log_scale": math.log(0.1) + init_std * torch.randn(dim, generator=generator)}
    elif cov_type == "full":
        diag = 0.05 + 0.05 * torch.rand(dim, generator=generator)
        post = {"loc": loc, "tril_raw": torch.diag(torch.log(diag))}
    else:
        raise ValueError(f"unknown cov_type {cov_type!r}")
    return {k: v.to(device) for k, v in post.items()}


def posterior_scale_tril(post):
    if "log_scale" in post:
        return torch.diag_embed(torch.exp(post["log_scale"]))
    raw = post["tril_raw"]
    return torch.tril(raw, -1) + torch.diag_embed(torch.exp(torch.diagonal(raw, dim1=-2, dim2=-1)))


def posterior_log_diag(post):
    if "log_scale" in post:
        return post["log_scale"]
    return torch.diagonal(post["tril_raw"], dim1=-2, dim2=-1)


def posterior_stddev(post):
    if "log_scale" in post:
        return torch.exp(post["log_scale"])
    L = posterior_scale_tril(post)
    return torch.sqrt(torch.sum(L * L, dim=-1))


def posterior_rsample(post, eps):
    """Reparameterised samples [M, P] from standard normals ``eps`` [M, P];
    stacked, leaves [S, P] and eps [S, M, P] -> [S, M, P]."""
    loc = post["loc"][..., None, :]
    if "log_scale" in post:
        return loc + torch.exp(post["log_scale"])[..., None, :] * eps
    return loc + eps @ posterior_scale_tril(post).mT


def posterior_log_prob(post, value):
    """value [..., P] -> [...]."""
    if "log_scale" in post:
        z = (value - post["loc"]) / torch.exp(post["log_scale"])
        return torch.sum(-0.5 * (z * z + _LOG_2PI) - post["log_scale"], dim=-1)
    L = posterior_scale_tril(post)
    r = value - post["loc"]
    r2 = r.reshape(-1, r.shape[-1])  # [S, P]
    z = torch.linalg.solve_triangular(L, r2.T, upper=False).T
    dim = post["loc"].shape[0]
    quad = torch.sum(z * z, dim=-1).reshape(r.shape[:-1])
    return -0.5 * (quad + dim * _LOG_2PI) - torch.sum(posterior_log_diag(post))


def posterior_entropy(post):
    """H(q), [] or [S] stacked."""
    dim = post["loc"].shape[-1]
    return 0.5 * dim * (1.0 + _LOG_2PI) + torch.sum(posterior_log_diag(post), dim=-1)


def posterior_kl_to_prior(post, hyper_prior: HyperPrior):
    """Closed-form KL(posterior || hyper_prior): both Gaussian, the prior
    factorised; [] or [S] stacked."""
    mu_p, sig_p = hyper_prior.loc, hyper_prior.scale
    quad = torch.sum(((post["loc"] - mu_p) / sig_p) ** 2, dim=-1)
    logdet_p = 2.0 * torch.sum(torch.log(sig_p))
    logdet_q = 2.0 * torch.sum(posterior_log_diag(post), dim=-1)
    dim = post["loc"].shape[-1]
    if "log_scale" in post:
        trace = torch.sum((torch.exp(post["log_scale"]) / sig_p) ** 2, dim=-1)
    else:
        trace = torch.sum((posterior_scale_tril(post) / sig_p[:, None]) ** 2, dim=(-2, -1))
    return 0.5 * (trace + quad - dim + logdet_p - logdet_q)


def neg_elbo(hyper_prior: HyperPrior, prior_factor, post, eps, X, Y, mask=None, counts=None,
             task_mll=gp_prior_mll_batch, task_sizes=None, with_prior=True):
    """PACOH-VI's loss: -(mean_s meta_log_prob(sample_s) + prior_factor * H(q)),
    the samples ``posterior_rsample(post, eps)``. E_q[log q] is the exact
    -H(q) of a Gaussian, not a sample estimate (as in the JAX package).
    Stacked (leaves [S, P], eps [S, M, P], prior_factor a number or [S]):
    one loss a fit, [S]. ``task_sizes`` and ``with_prior`` as in
    ``meta_log_prob``: without the prior, neither the hyper-prior nor the
    entropy term (a task shard's share of the loss)."""
    samples = posterior_rsample(post, eps)
    lp = meta_log_prob(hyper_prior, prior_factor, samples, X, Y, mask, counts=counts,
                       task_mll=task_mll, task_sizes=task_sizes, with_prior=with_prior)
    if not with_prior:
        return -torch.mean(lp, dim=-1)
    return -(torch.mean(lp, dim=-1) + per_seed(prior_factor, 1) * posterior_entropy(post))
