"""Latent-variable Neural Process as functions of a parameter dict (counterpart of meta_learning_pacoh_tpu/models/neural_process.py).

  encoder    (x, y) -> r_i           ReLU MLP [h, h] -> r_dim
  aggregate  mean over (real) points
  mu/sigma   r -> (mu, 0.1 + 0.9 sigmoid(.))
  decoder    (x, z) -> (mu_y, 0.1 + 0.9 softplus(.))

Parameters {'w_enc_0', 'b_enc_0', ..., 'w_dsig', 'b_dsig'} carry the JAX
package's names and shapes (weights input-major: x @ w + b), so a JAX
parameter dict copies across without renaming. Every function takes any
leading batch axes on its data (a task or image batch) and shares the
parameters across them, or with a leading axis S on the parameters (S
stacked fits) takes data [S, ...], each fit its own. The random draws are
arguments: the shuffle scores and the latent noise come from the caller,
which decides where they are drawn.
"""

import math

import torch

from meta_learning_pacoh_torch.ops.kernels import softplus

_LOG_2PI = math.log(2.0 * math.pi)


def _linear(params, name, x):
    """x @ w + b; stacked fits' parameters [S, in, out] and [S, out] take x
    [S, ..., in], each fit its own."""
    w, b = params[f"w_{name}"], params[f"b_{name}"]
    if w.dim() == 2:
        return x @ w + b
    h = torch.baddbmm(b[:, None, :], x.reshape(x.shape[0], -1, x.shape[-1]), w)
    return h.reshape(*x.shape[:-1], w.shape[-1])


def _init_linear(generator, fan_in, fan_out):
    bound = 1.0 / math.sqrt(fan_in)
    w = (torch.rand(fan_in, fan_out, generator=generator) * 2.0 - 1.0) * bound
    b = (torch.rand(fan_out, generator=generator) * 2.0 - 1.0) * bound
    return w, b


def init_np_params(generator, x_dim, y_dim, r_dim=50, z_dim=50, h_dim=50):
    """Initial parameters, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for w and b,
    drawn from ``generator`` (a CPU ``torch.Generator``)."""
    p = {}
    for i, (fi, fo) in enumerate([(x_dim + y_dim, h_dim), (h_dim, h_dim), (h_dim, r_dim)]):
        p[f"w_enc_{i}"], p[f"b_enc_{i}"] = _init_linear(generator, fi, fo)
    p["w_rh"], p["b_rh"] = _init_linear(generator, r_dim, r_dim)
    p["w_rmu"], p["b_rmu"] = _init_linear(generator, r_dim, z_dim)
    p["w_rsig"], p["b_rsig"] = _init_linear(generator, r_dim, z_dim)
    for i, (fi, fo) in enumerate([(x_dim + z_dim, h_dim), (h_dim, h_dim), (h_dim, h_dim)]):
        p[f"w_dec_{i}"], p[f"b_dec_{i}"] = _init_linear(generator, fi, fo)
    p["w_dmu"], p["b_dmu"] = _init_linear(generator, h_dim, y_dim)
    p["w_dsig"], p["b_dsig"] = _init_linear(generator, h_dim, y_dim)
    return p


def np_encode(params, x, y, mask=None):
    """(x [..., N, Dx], y [..., N, Dy]) -> (mu_z, sigma_z) [..., Dz].

    mask [..., N] (1 real, 0 padding) keeps padded points out of the mean.
    """
    h = torch.cat([x, y], dim=-1)
    h = torch.relu(_linear(params, "enc_0", h))
    h = torch.relu(_linear(params, "enc_1", h))
    r_i = _linear(params, "enc_2", h)  # [..., N, r]
    if mask is None:
        r = torch.mean(r_i, dim=-2)
    else:
        r = (torch.sum(r_i * mask[..., None], dim=-2)
             / torch.clamp_min(torch.sum(mask, dim=-1), 1.0)[..., None])
    hidden = torch.relu(_linear(params, "rh", r))
    mu = _linear(params, "rmu", hidden)
    sigma = 0.1 + 0.9 * torch.sigmoid(_linear(params, "rsig", hidden))
    return mu, sigma


def np_decode(params, x, z):
    """(x [..., N, Dx], z [..., Dz]) -> (mu_y, sigma_y) [..., N, Dy]."""
    zt = z[..., None, :].expand(*x.shape[:-1], z.shape[-1])
    h = torch.cat([x, zt], dim=-1)
    h = torch.relu(_linear(params, "dec_0", h))
    h = torch.relu(_linear(params, "dec_1", h))
    h = torch.relu(_linear(params, "dec_2", h))
    mu = _linear(params, "dmu", h)
    sigma = 0.1 + 0.9 * softplus(_linear(params, "dsig", h))
    return mu, sigma


def gaussian_kl(mu_t, sig_t, mu_c, sig_c):
    """KL(N(mu_t, sig_t) || N(mu_c, sig_c)) summed over the last axis."""
    return torch.sum(torch.log(sig_c) - torch.log(sig_t)
                     + (sig_t ** 2 + (mu_t - mu_c) ** 2) / (2.0 * sig_c ** 2) - 0.5, dim=-1)


def np_elbo_loss(params, u, eps, x, y, num_context, mask=None):
    """Per-task NP training loss (reference: NPR_meta.py:228-252):
    -sum log p(y_target | z ~ q_target) + KL(q_target || q_context), the
    context the first ``num_context`` points of a shuffled target set.

    x [..., N, Dx], y [..., N, Dy], num_context [...] (an integer tensor),
    mask [..., N] marks real points. The draws: ``u`` [..., N] uniform
    scores that order the points (padding pushed to the back by +10, ties
    kept in place), ``eps`` [..., Dz] standard normals for z. Returns [...].
    """
    n = x.shape[-2]
    if mask is None:
        mask = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    perm = torch.argsort(u + (1.0 - mask) * 10.0, dim=-1, stable=True)
    x_t = torch.gather(x, -2, perm[..., None].expand(x.shape))
    y_t = torch.gather(y, -2, perm[..., None].expand(y.shape))
    m_t = torch.gather(mask, -1, perm)
    pos = torch.arange(n, device=x.device)
    ctx_mask = (pos < torch.as_tensor(num_context, device=x.device)[..., None]).to(x.dtype) * m_t

    mu_t, sig_t = np_encode(params, x_t, y_t, mask=m_t)
    mu_c, sig_c = np_encode(params, x_t, y_t, mask=ctx_mask)
    z = mu_t + sig_t * eps
    mu_y, sig_y = np_decode(params, x_t, z)
    log_lik = torch.sum(m_t[..., None] * (-0.5 * ((y_t - mu_y) / sig_y) ** 2
                                         - torch.log(sig_y) - 0.5 * _LOG_2PI), dim=(-2, -1))
    return -log_lik + gaussian_kl(mu_t, sig_t, mu_c, sig_c)


def np_predict(params, eps, x_context, y_context, x_test):
    """Eval-mode prediction, z = mu_c + sigma_c eps from q(z | context)
    (reference: neural_process.py:124-135): (mu_y, sigma_y) [..., Nt, Dy]."""
    mu_c, sig_c = np_encode(params, x_context, y_context)
    return np_decode(params, x_test, mu_c + sig_c * eps)
