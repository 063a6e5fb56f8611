"""Plain PyTorch reference of PACOH-MLAP: its meta-training step, its
meta-test and its predictive, and the learner's draws.

The state is a diagonal Gaussian hyper-posterior N(loc, exp(log_scale)^2)
over the flat GP-prior parameters, a raw likelihood noise (variance
softplus(raw) + 1e-4), and one Gaussian q_t = N(m_t, L_t L_t^T) a task over
the function at its points. The loss of a step is the nested PAC-Bayes bound

    sum_t u_t [ -avg_ll_t + sqrt((KL_out + KL_in,t + log 2 + log n_t + log M - log delta)
                                 / (2 (n_t - 1))) ] + sqrt((KL_out + log 2 + log M - log delta)
                                                           / (2 (M - 1)))

with u_t the share of the step's task draws (M draws with replacement of
the M meta-train tasks), KL_out = meta_kl_weight KL(hyper-posterior ||
hyper-prior), KL_in,t = task_kl_weight mean_s KL(q_t || GP prior of sample s
at the task's points) over S samples loc + exp(log_scale) eps_s. Its
gradient is taken by autograd, and Adam (one step count) moves every leaf.

The meta-test fits fresh posteriors of the context sets with the
hyper-posterior and the noise frozen: the loss is the plain sum of the
bounds, Adam at lr 1e-2 from zero moments. Each q_t starts at the GP prior
moment-matched over 20 hyper-posterior samples (mean + 1e-3 eps, the factor
of cov + 1e-3 I). The predictive is the sparse-GP predictive under the
aggregated prior of 20 further samples, plus the noise.

The draws follow the learner's protocol, with torch's own generators: a CPU
generator seeded with the learner's seed draws the initial loc and log_scale
(0.1 N(0, 1) and log 0.1 + 0.1 N(0, 1)) and then one 62-bit seed a use;
numpy's ``SeedSequence`` splits them; the noise comes from generators on the
learner's device.
"""

import math

import numpy as np
import torch

from benchmark.reference import gp

N_AGG = 20  # hyper-posterior samples of the aggregated prior
KL_LEVELS = (1e-6, 1e-4, 1e-2)  # the jitter of a prior covariance in a KL
MEAN_LEVELS = (1e-6, 1e-4, 1e-2)  # the jitter of the predictive's context factor
LL_LEVELS = (1e-6, 1e-2, 1e-1, 1.0)  # relative jitter of the predictive's density


class Spec:
    def __init__(self, kw, d, n_iter_meta_test=3000):
        self.hidden = tuple(kw.get("mean_nn_layers", (32, 32)))
        self.s = int(kw.get("svi_batch_size", 5))
        self.lr = float(kw.get("lr", 1e-3))
        self.lr_post = self.lr * float(kw.get("posterior_lr_multiplier", 1.0))
        self.wps = float(kw.get("weight_prior_std", 0.5))
        self.bps = float(kw.get("bias_prior_std", 3.0))
        self.delta = float(kw.get("delta", 0.1))
        self.task_kl = float(kw.get("task_kl_weight", 1.0))
        self.meta_kl = float(kw.get("meta_kl_weight", 1.0))
        self.noise_init = float(kw.get("likelihood_noise_init", 0.01))
        self.n_iter_meta_test = int(n_iter_meta_test)
        self.lay, self.p = gp.layout(d, self.hidden, int(kw.get("feature_dim", 1)))


def child_seeds(seed, n):
    return [int(s) for s in np.random.SeedSequence([int(seed)]).generate_state(n)]


class LearnerDraws:
    """The learner's CPU generator: its initial hyper-posterior, then one
    62-bit seed a use (``next_seed``): the meta-train posteriors', the
    training seed's, and one a meta-test call."""

    def __init__(self, seed, p):
        self.gen = torch.Generator().manual_seed(int(seed))
        self.loc = 0.1 * torch.randn(p, generator=self.gen)
        self.log_scale = math.log(0.1) + 0.1 * torch.randn(p, generator=self.gen)
        self.init_seed = self.next_seed()
        self.train_seed = self.next_seed() % 2 ** 31

    def next_seed(self):
        return int(torch.randint(0, 2 ** 62, (1,), generator=self.gen))


def device_randn(shape, seed, device):
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(shape, generator=gen, device=device)


def step_eps(train_seed, step, s, p, device):
    """[S, P] standard normals of meta-training step ``step``."""
    seed = int(np.random.SeedSequence([train_seed, step]).generate_state(2)[1])
    out = torch.empty(s, p, device=device)
    return out.normal_(generator=torch.Generator(device=device).manual_seed(seed))


def step_counts(train_seed, step, m):
    """[M] draw counts of step ``step``: M draws with replacement of M tasks."""
    seed = int(np.random.SeedSequence([train_seed, step]).generate_state(1)[0])
    idx = torch.randint(0, m, (m,), generator=torch.Generator().manual_seed(seed))
    return torch.bincount(idx, minlength=m)


def prior_at(spec, theta, X):
    """(mean [S, T, N], Gram [S, T, N, N]) of parameter samples theta [S, P]
    at X [T, N, D]."""
    leaves = {k: v.unsqueeze(1) for k, v in gp.unflatten(spec.lay, theta).items()}
    return gp.prior_moments_at(leaves, X.expand(theta.shape[0], *X.shape), len(spec.hidden))


def aggregated(spec, theta, X):
    """The GP prior moment-matched over the samples theta [S, P] at X [T, N, D]:
    (mean [T, N], cov [T, N, N]) with 1e-5 on the diagonal."""
    mean_s, gram_s = prior_at(spec, theta, X)
    mean = mean_s.mean(0)
    resid = mean_s - mean
    eye = torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
    cov = gram_s.mean(0) + (resid.unsqueeze(-1) * resid.unsqueeze(-2)).mean(0) + 1e-5 * eye
    return mean, cov


def init_posteriors(spec, loc, log_scale, X, seed):
    """(q_means [T, N], q_trils [T, N, N]) at the aggregated prior of 20
    samples at X, drawn from ``seed``."""
    s_theta, s_eps = child_seeds(seed, 2)
    dev, dt = X.device, X.dtype
    eps = device_randn(X.shape[:2], s_eps, dev).to(dt)
    theta = loc + torch.exp(log_scale) * device_randn((N_AGG, spec.p), s_theta, dev).to(dt)
    mean, cov = aggregated(spec, theta, X)
    eye = torch.eye(X.shape[1], dtype=dt, device=dev)
    return mean + 1e-3 * eps, gp.factor_levels(cov + 1e-3 * eye, (1e-6, 1e-4, 1e-2))


def kl_outer(spec, loc, log_scale, prior_loc, prior_scale):
    """meta_kl_weight KL(N(loc, exp(log_scale)^2) || N(prior_loc, prior_scale^2))."""
    r = (loc - prior_loc) / prior_scale
    kl = 0.5 * torch.sum((torch.exp(log_scale) / prior_scale) ** 2 + r * r - 1.0
                         + 2.0 * torch.log(prior_scale) - 2.0 * log_scale)
    return spec.meta_kl * kl


def prior_factors(spec, theta, X):
    """(prior mean [S, T, N], its covariance's inverse [S, T, N, N] and
    log-determinant [S, T]) at the jitter level of the KL's rule."""
    mean, gram = prior_at(spec, theta, X)
    lower = gp.factor_levels(gram, KL_LEVELS)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(lower, dim1=-2, dim2=-1)), dim=-1)
    return mean, torch.cholesky_inverse(lower), logdet


def task_bounds(spec, q_means, q_trils, Y, prior, noise_var, klo, n_meta):
    """[T] PAC bound terms of the tasks at the prior factors ``prior``."""
    mean, kinv, logdet1 = prior
    n = Y.shape[-1]
    L = torch.tril(q_trils)
    f_var = torch.sum(L * L, dim=-1)
    lp = -0.5 * (((Y - q_means) ** 2 + f_var) / noise_var + torch.log(noise_var) + gp.LOG_2PI)
    avg_ll = lp.mean(-1)
    d = mean - q_means
    quad = torch.einsum("sti,stij,stj->st", d, kinv, d)
    trace = torch.sum(kinv * (L @ L.mT), dim=(-2, -1))
    logdet0 = 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(L, dim1=-2, dim2=-1)) + 1e-12),
                              dim=-1)
    kl = 0.5 * (trace + quad - n + logdet1 - logdet0)  # [S, T]
    kl_in = spec.task_kl * kl.mean(0)
    const = math.log(2.0) + math.log(n) + math.log(n_meta) - math.log(spec.delta)
    return -avg_ll + torch.sqrt((klo + kl_in + const) / (2.0 * (n - 1.0)))


def noise_var(raw):
    return gp.softplus(raw) + 1e-4


def adam(x, m, v, g, t, lr):
    m.mul_(0.9).add_(0.1 * g)
    v.mul_(0.999).add_(0.001 * g * g)
    x.sub_(lr * (m / (1.0 - 0.9 ** t)) / (torch.sqrt(v / (1.0 - 0.999 ** t)) + 1e-8))


STATE = ("loc", "log_scale", "raw_noise", "q_means", "q_trils")


def initial_state(spec, draws, X, dtype):
    loc = draws.loc.to(X.device, dtype)
    log_scale = draws.log_scale.to(X.device, dtype)
    q_means, q_trils = init_posteriors(spec, loc, log_scale, X, draws.init_seed)
    raw = math.log(math.expm1(spec.noise_init - 1e-4))
    return {"loc": loc, "log_scale": log_scale,
            "raw_noise": torch.tensor(raw, dtype=dtype, device=X.device),
            "q_means": q_means, "q_trils": q_trils}


def fit_loss(spec, state, eps, counts, X, Y, prior_loc, prior_scale):
    """The meta-training loss of a step at ``state`` (a dict of STATE) with
    the step's normals eps [S, P] and draw counts [M]."""
    m = X.shape[0]
    theta = state["loc"] + torch.exp(state["log_scale"]) * eps
    klo = kl_outer(spec, state["loc"], state["log_scale"], prior_loc, prior_scale)
    mean, gram = prior_at(spec, theta, X)
    lower = gp.factor_levels(gram, KL_LEVELS)
    logdet1 = 2.0 * torch.sum(torch.log(torch.diagonal(lower, dim1=-2, dim2=-1)), dim=-1)
    bounds = task_bounds(spec, state["q_means"], state["q_trils"], Y,
                         (mean, torch.cholesky_inverse(lower), logdet1),
                         noise_var(state["raw_noise"]), klo, m)
    u = counts / counts.sum()
    meta_c = torch.sqrt((klo + math.log(2.0) + math.log(m) - math.log(spec.delta))
                        / (2.0 * (m - 1.0)))
    return torch.sum(torch.where(counts > 0, u * bounds, 0.0)) + meta_c


def follow(spec, train_seed, state, mom, step0, count0, n_steps, X, Y, keep=None):
    """n_steps meta-training steps from global step ``step0`` on ``state`` (a
    dict of STATE) with Adam moments ``mom`` ({key: (m, v)}, ``count0`` steps
    taken), both updated in place, on the normalised tasks X [M, N, D], Y [M, N]
    of the state's type; ``keep`` [M] (a fault) zeroes the draws of the tasks
    it leaves out, so the mean is taken over the rest. Returns (the first
    step's gradients, [the loss of each step])."""
    prior_loc, prior_scale = (a.to(X.dtype) for a in
                              gp.hyper_prior(spec.lay, spec.p, spec.wps, spec.bps, X.device))
    m = X.shape[0]
    losses, grad1 = [], None
    for i in range(n_steps):
        step = step0 + i
        eps = step_eps(train_seed, step, spec.s, spec.p, X.device).to(X.dtype)
        counts = step_counts(train_seed, step, m).to(X.device, X.dtype)
        if keep is not None:
            counts = counts * keep
        leaf = {k: v.detach().requires_grad_(True) for k, v in state.items()}
        loss = fit_loss(spec, leaf, eps, counts, X, Y, prior_loc, prior_scale)
        grads = torch.autograd.grad(loss, [leaf[k] for k in STATE])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if grad1 is None:
                grad1 = {k: g.clone() for k, g in zip(STATE, grads)}
            for k, g in zip(STATE, grads):
                adam(state[k], *mom[k], g, count0 + i + 1,
                     spec.lr_post if k.startswith("q_") else spec.lr)
    return grad1, losses


def fit_steps(spec, seed, X, Y, n_steps=3, dtype=torch.float64, keep=None):
    """The first meta-training steps from the learner's seed on the normalised
    tasks X [M, N, D], Y [M, N]: (state0, the first step's gradients, the
    state after n_steps, [the loss of each step]), dicts of STATE; ``keep``
    as ``follow``'s."""
    X, Y = X.to(dtype), Y.to(dtype)
    draws = LearnerDraws(seed, spec.p)
    state = initial_state(spec, draws, X, dtype)
    state0 = {k: v.clone() for k, v in state.items()}
    mom = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in state.items()}
    grad1, losses = follow(spec, draws.train_seed, state, mom, 0, 0, n_steps, X, Y, keep)
    return state0, grad1, state, losses


def blocks(n_iter, block):
    """(step0, steps) of the meta-test's noise blocks of ``block`` steps."""
    return [(s, min(block, n_iter - s)) for s in range(0, n_iter, block)]


def meta_test(spec, fitted, call_seed, Xc, Yc, n_meta, dtype=torch.float64, block=512):
    """The meta-test's posteriors of the context sets Xc [T, N, D], Yc [T, N]
    from the fitted hyper-posterior and noise (``fitted``: loc, log_scale,
    raw_noise) and the call's seed, its noise drawn a block of ``block`` steps
    at a time: (q_means, q_trils, theta_agg [20, P])."""
    dev = Xc.device
    Xc, Yc = Xc.to(dtype), Yc.to(dtype)
    loc, log_scale, raw = (torch.as_tensor(fitted[k], device=dev).to(dtype)
                           for k in ("loc", "log_scale", "raw_noise"))
    s_init, s_opt, s_theta = child_seeds(call_seed, 3)
    prior_loc, prior_scale = (a.to(dtype) for a in
                              gp.hyper_prior(spec.lay, spec.p, spec.wps, spec.bps, dev))
    theta_agg = loc + torch.exp(log_scale) * device_randn((N_AGG, spec.p), s_theta, dev).to(dtype)
    q = dict(zip(("q_means", "q_trils"), init_posteriors(spec, loc, log_scale, Xc, s_init)))
    mom = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in q.items()}
    klo = kl_outer(spec, loc, log_scale, prior_loc, prior_scale)
    nv = noise_var(raw)
    scale = torch.exp(log_scale)
    for step0, n in blocks(spec.n_iter_meta_test, block):
        block_seed = int(np.random.SeedSequence([s_opt, step0]).generate_state(1)[0])
        eps = device_randn((n, spec.s, spec.p), block_seed, dev).to(dtype)
        for i in range(n):
            with torch.no_grad():
                prior = prior_factors(spec, loc + scale * eps[i], Xc)
            leaf = {k: v.detach().requires_grad_(True) for k, v in q.items()}
            loss = task_bounds(spec, leaf["q_means"], leaf["q_trils"], Yc, prior, nv, klo,
                               n_meta).sum()
            grads = torch.autograd.grad(loss, [leaf["q_means"], leaf["q_trils"]])
            with torch.no_grad():
                for k, g in zip(("q_means", "q_trils"), grads):
                    adam(q[k], *mom[k], g, step0 + i + 1, 1e-2)
    return q["q_means"], q["q_trils"], theta_agg


def predictive(spec, q_means, q_trils, theta_agg, Xc, TX, raw_noise, block=50):
    """(mean [T, Nt], cov [T, Nt, Nt]) of the sparse-GP predictive at TX under
    the aggregated prior of theta_agg, in normalised units, noise added;
    computed ``block`` tasks at a time."""
    nc = Xc.shape[1]
    nv = noise_var(torch.as_tensor(raw_noise, dtype=Xc.dtype, device=Xc.device))
    means, covs = [], []
    for lo in range(0, Xc.shape[0], block):
        sl = slice(lo, lo + block)
        mean, cov = aggregated(spec, theta_agg, torch.cat([Xc[sl], TX[sl]], dim=1))
        m_c, m_t = mean[:, :nc], mean[:, nc:]
        k_cc, k_ct, k_tt = cov[:, :nc, :nc], cov[:, :nc, nc:], cov[:, nc:, nc:]
        lower = gp.factor_levels(k_cc, MEAN_LEVELS)
        a = torch.cholesky_solve(k_ct, lower)
        v = torch.linalg.solve_triangular(lower, k_ct, upper=False)
        sa = torch.tril(q_trils[sl]).mT @ a
        means.append(m_t + (a.mT @ (q_means[sl] - m_c).unsqueeze(-1))[..., 0])
        eye = torch.eye(TX.shape[1], dtype=Xc.dtype, device=Xc.device)
        covs.append(k_tt - v.mT @ v + sa.mT @ sa + nv * eye)
    return torch.cat(means), torch.cat(covs)


def eval_metrics(mean, cov, y, y_mean, y_std):
    """Each task's (LL / point, RMSE, calibration error) [T] of the predictive
    (normalised units) at the raw targets y [T, Nt]."""
    n = y.shape[-1]
    y_n = (y - y_mean) / y_std
    ll = (gp.gauss_logpdf(y_n, mean, cov, LL_LEVELS, relative=True) - n * math.log(y_std)) / n
    mean_o = y_mean + y_std * mean
    std_o = y_std * torch.sqrt(torch.diagonal(cov, dim1=-2, dim2=-1))
    rmse = torch.sqrt(torch.mean((mean_o - y) ** 2, dim=-1))
    cdf = 0.5 * (1.0 + torch.erf((y - mean_o) / (std_o * math.sqrt(2.0))))
    levels = torch.linspace(0.05, 0.95, 20, dtype=y.dtype, device=y.device)
    freq = torch.sum(cdf.unsqueeze(-1) <= levels, dim=-2) / n
    calib = torch.sqrt(torch.mean((freq - levels) ** 2, dim=-1))
    return ll, rmse, calib
