"""NN mean + NN-featurised RBF-ARD kernel + noise (counterpart of meta_learning_pacoh_tpu/models/gp_base.py).

One static config, one parameter dict, plain functions. Every parameter
leaf carries a leading particle axis K ([K, ...]); inputs carry it too,
x [K, ..., N, D] (expand a shared input with ``x.expand(K, ...)``), and
every result keeps it. The two constraint flavours of the JAX package:

- MAP flavour (``has_outputscale=True, noise_floor=1e-3``);
- RandomGP flavour (``has_outputscale=False, noise_floor=0``), which
  PACOH-SVGD uses.

``gp_noise`` is the observation-noise variance. The custom ``MeanModule`` /
``KernelModule`` hooks of the JAX package are not ported yet.
"""

import dataclasses

import torch
from torch.nn.functional import softplus

from meta_learning_pacoh_torch.models.mlp import init_mlp_params, mlp_apply
from meta_learning_pacoh_torch.ops import gp as gp_ops
from meta_learning_pacoh_torch.ops.kernels import rbf_ard


@dataclasses.dataclass(frozen=True)
class GPConfig:
    input_dim: int
    feature_dim: int = 2
    mean_module: str = "NN"  # 'NN' | 'constant' | 'zero'
    covar_module: str = "NN"  # 'NN' | 'SE'
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
    if cfg.mean_module == "NN":
        params["mean_nn"] = init_mlp_params(generator, cfg.input_dim, 1,
                                            cfg.mean_nn_layers, scheme=cfg.init_scheme)
    elif cfg.mean_module == "constant":
        params["constant_mean"] = torch.zeros(1)
    elif cfg.mean_module != "zero":
        raise ValueError(f"unknown mean_module {cfg.mean_module!r}")
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


def _per_particle(t, x):
    """Reshape t [K, *rest] to broadcast against x [K, ..., *rest]."""
    mid = x.dim() - t.dim()
    return t.reshape(t.shape[:1] + (1,) * mid + t.shape[1:])


def gp_mean(cfg: GPConfig, params, x):
    """Prior mean at x [K, ..., N, D] -> [K, ..., N]."""
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
    """(lengthscale [K, F], outputscale [K] or 1.0, noise [K])."""
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
    f1 = gp_features(cfg, params, x1)
    f2 = f1 if x2 is None else gp_features(cfg, params, x2)
    ls, os_, _ = gp_hypers(cfg, params)
    return _rbf(f1, f2, ls, os_)


def gp_predict(cfg: GPConfig, params, x_context, y_context, x_test, mask_c=None,
               observation_noise=True):
    """Posterior predictive at x_test given context data.

    x_context [K, ..., Nc, D], y_context [..., Nc], x_test [K, ..., Nt, D]
    -> (mean [K, ..., Nt], cov [K, ..., Nt, Nt]); cov includes the
    observation noise when asked.
    """
    noise = gp_noise(cfg, params)
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
