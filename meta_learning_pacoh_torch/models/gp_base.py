"""NN mean + NN-featurised RBF-ARD kernel + noise (counterpart of meta_learning_pacoh_tpu/models/gp_base.py).

One static config, one parameter dict, plain functions. Every parameter
leaf carries a leading particle axis K ([K, ...]); inputs carry it too,
x [K, ..., N, D] (expand a shared input with ``x.expand(K, ...)``), and
every result keeps it. The two constraint flavours of the JAX package:

- MAP flavour (``has_outputscale=True, noise_floor=1e-3``);
- RandomGP flavour (``has_outputscale=False, noise_floor=0``), which
  PACOH-SVGD uses.

PACOH-MAP has one parameter set, and carries K=1.

``gp_noise`` is the observation-noise variance. ``mean_module`` and
``covar_module`` also take a ``models.modules.MeanModule`` /
``KernelModule`` instance: its leaves sit under 'custom_mean' /
'custom_kernel', and a custom kernel owns its hyperparameters (no
lengthscale or outputscale; the noise stays the framework's).
"""

import dataclasses

import torch
from torch.nn.functional import softplus

from meta_learning_pacoh_torch.models.mlp import init_mlp_params, mlp_apply
from meta_learning_pacoh_torch.models.modules import KernelModule, MeanModule
from meta_learning_pacoh_torch.ops import gp as gp_ops
from meta_learning_pacoh_torch.ops.kernels import rbf_ard


@dataclasses.dataclass(frozen=True)
class GPConfig:
    input_dim: int
    feature_dim: int = 2
    mean_module: object = "NN"  # 'NN' | 'constant' | 'zero' | a MeanModule instance
    covar_module: object = "NN"  # 'NN' | 'SE' | a KernelModule instance
    mean_nn_layers: tuple = (32, 32)
    kernel_nn_layers: tuple = (32, 32)
    has_outputscale: bool = True
    noise_floor: float = 1e-3
    init_scheme: str = "torch_linear"

    @property
    def ard_dims(self):
        return self.feature_dim if self.covar_module == "NN" else self.input_dim


def init_gp_params(cfg: GPConfig, generator):
    """Unbatched parameter dict; raw hyperparameters start at 0."""
    params = {}
    if isinstance(cfg.mean_module, MeanModule):
        params["custom_mean"] = cfg.mean_module.init_params(generator, cfg.input_dim)
    elif cfg.mean_module == "NN":
        params["mean_nn"] = init_mlp_params(generator, cfg.input_dim, 1,
                                            cfg.mean_nn_layers, scheme=cfg.init_scheme)
    elif cfg.mean_module == "constant":
        params["constant_mean"] = torch.zeros(1)
    elif cfg.mean_module != "zero":
        raise ValueError(f"unknown mean_module {cfg.mean_module!r}")
    if isinstance(cfg.covar_module, KernelModule):
        params["custom_kernel"] = cfg.covar_module.init_params(generator, cfg.input_dim)
        params["noise_raw"] = torch.zeros(())
        return params
    if cfg.covar_module == "NN":
        params["kernel_nn"] = init_mlp_params(generator, cfg.input_dim, cfg.feature_dim,
                                              cfg.kernel_nn_layers, scheme=cfg.init_scheme)
    elif cfg.covar_module != "SE":
        raise ValueError(f"unknown covar_module {cfg.covar_module!r}")
    params["lengthscale_raw"] = torch.zeros(cfg.ard_dims)
    if cfg.has_outputscale:
        params["outputscale_raw"] = torch.zeros(())
    params["noise_raw"] = torch.zeros(())
    return params


def tree_map(fn, tree):
    """fn applied to every leaf of a nested dict of tensors."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _per_particle(t, x):
    """Reshape t [K, *rest] to broadcast against x [K, ..., *rest]."""
    mid = x.dim() - t.dim()
    return t.reshape(t.shape[:1] + (1,) * mid + t.shape[1:])


def gp_mean(cfg: GPConfig, params, x):
    """Prior mean at x [K, ..., N, D] -> [K, ..., N]."""
    if isinstance(cfg.mean_module, MeanModule):
        return cfg.mean_module.mean(params["custom_mean"], x)
    if cfg.mean_module == "NN":
        return mlp_apply(params["mean_nn"], x)[..., 0]
    if cfg.mean_module == "constant":
        c = params["constant_mean"][:, 0]
        return _per_particle(c, x[..., 0]).expand(x.shape[:-1])
    return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


def gp_features(cfg: GPConfig, params, x):
    if cfg.covar_module == "NN":
        return mlp_apply(params["kernel_nn"], x)
    return x


def gp_noise(cfg: GPConfig, params):
    """Observation-noise variance [K]."""
    return softplus(params["noise_raw"]) + cfg.noise_floor


def gp_hypers(cfg: GPConfig, params):
    """(lengthscale [K, F], outputscale [K] or 1.0, noise [K]); a custom
    kernel owns its hyperparameters: (None, None, noise)."""
    if isinstance(cfg.covar_module, KernelModule):
        return None, None, gp_noise(cfg, params)
    ls = softplus(params["lengthscale_raw"])
    os_ = softplus(params["outputscale_raw"]) if cfg.has_outputscale else 1.0
    return ls, os_, gp_noise(cfg, params)


def _rbf(f1, f2, ls, os_):
    k = rbf_ard(f1, f2, _per_particle(ls, f1[..., 0, :]))
    if isinstance(os_, torch.Tensor):
        k = _per_particle(os_, k[..., 0, 0])[..., None, None] * k
    return k


def gp_gram(cfg: GPConfig, params, x1, x2=None):
    """Kernel matrix: x1 [K, ..., N, D], x2 [K, ..., M, D] -> [K, ..., N, M]."""
    if isinstance(cfg.covar_module, KernelModule):
        return cfg.covar_module.gram(params["custom_kernel"], x1, x1 if x2 is None else x2)
    f1 = gp_features(cfg, params, x1)
    f2 = f1 if x2 is None else gp_features(cfg, params, x2)
    ls, os_, _ = gp_hypers(cfg, params)
    return _rbf(f1, f2, ls, os_)


def broadcast_data(a, lead, event_dims):
    """Data a [*seeds, *event] (seeds a prefix of ``lead``, maybe empty)
    broadcast to [*lead, *event]."""
    seeds, event = a.shape[:a.dim() - event_dims], a.shape[a.dim() - event_dims:]
    return a.reshape(*seeds, *(1,) * (len(lead) - len(seeds)), *event).expand(*lead, *event)


def gp_prior_mll_batch(cfg: GPConfig, params, X, Y, mask=None):
    """Exact MLL / n of T tasks under each of K parameter sets.

    Leaves [K, ...], X [T, N, D], Y [T, N], mask [T, N] or None, shared by
    the K sets -> [K, T]. Stacked fits give the leaves a leading seed axis,
    [S, K, ...], and the data [S, T, ...] (per seed) or [T, ...] (shared)
    -> [S, K, T]. The O(N^3) cores of all systems go through one
    ``gp_mll_batch`` call.
    """
    lead = params["noise_raw"].shape
    t, n = X.shape[-3], Y.shape[-1]
    if mask is None:
        mask = torch.ones_like(Y)
    if len(lead) > 1:  # one particle axis of all S * K parameter sets
        params = tree_map(lambda a: a.reshape(-1, *a.shape[len(lead):]), params)
    x = broadcast_data(X, lead, 3).reshape(-1, *X.shape[-3:])
    k = x.shape[0]
    means = gp_mean(cfg, params, x)  # [K, T, N]
    grams = gp_gram(cfg, params, x)  # [K, T, N, N]
    noise = gp_noise(cfg, params)  # [K]
    lls = gp_ops.gp_mll_batch(
        means.reshape(-1, n), grams.reshape(-1, n, n), broadcast_data(Y, lead, 2).reshape(-1, n),
        noise[:, None].expand(k, t).reshape(-1), broadcast_data(mask, lead, 2).reshape(-1, n))
    return lls.reshape(*lead, t)


def gp_prior_mll(cfg: GPConfig, params, x, y, mask=None):
    """Exact MLL / n of one task: x [N, D], y [N], mask [N] or None -> [K]."""
    return gp_prior_mll_batch(cfg, params, x[None], y[None],
                              None if mask is None else mask[None])[:, 0]


def gp_predict(cfg: GPConfig, params, x_context, y_context, x_test, mask_c=None,
               observation_noise=True):
    """Posterior predictive at x_test given context data.

    x_context [K, ..., Nc, D], y_context [..., Nc], x_test [K, ..., Nt, D]
    -> (mean [K, ..., Nt], cov [K, ..., Nt, Nt]); cov includes the
    observation noise when asked.
    """
    noise = gp_noise(cfg, params)
    if isinstance(cfg.covar_module, KernelModule):
        K_cc = gp_gram(cfg, params, x_context)
        K_ct = gp_gram(cfg, params, x_context, x_test)
        K_tt = gp_gram(cfg, params, x_test)
    else:  # featurise once, reuse across the three Grams
        f_c = gp_features(cfg, params, x_context)
        f_t = gp_features(cfg, params, x_test)
        ls, os_, _ = gp_hypers(cfg, params)
        K_cc = _rbf(f_c, f_c, ls, os_)
        K_ct = _rbf(f_c, f_t, ls, os_)
        K_tt = _rbf(f_t, f_t, ls, os_)
    mean_c = gp_mean(cfg, params, x_context)
    mean_t = gp_mean(cfg, params, x_test)
    noise_b = _per_particle(noise, mean_c[..., 0])
    post_mean, post_cov = gp_ops.gp_posterior(
        mean_c, K_cc, K_ct, mean_t, K_tt, y_context, noise_b, mask_c=mask_c)
    if observation_noise:
        eye = torch.eye(post_cov.shape[-1], dtype=post_cov.dtype, device=post_cov.device)
        post_cov = post_cov + noise_b[..., None, None] * eye
    return post_mean, post_cov
