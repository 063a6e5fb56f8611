"""PACOH-MLAP/PAC: a nested two-level PAC-Bayes bound with per-task
variational GP posteriors (counterpart of meta_learning_pacoh_tpu/algos/pacoh_mlap.py).

A Gaussian hyper-posterior over GP-prior parameters, a global likelihood
noise, and one Gaussian q_t(f) = N(q_means[t], L_t L_t^T) per task at its
train points, trained jointly on

    loss = sum_t u_t [ -avg E_{q_t}[ll] + sqrt((KL_out + KL_in,t + log 2 + log n_t
                                                + log m - log delta) / (2 (n_t - 1))) ]
           + sqrt((KL_out + log 2 + log m - log delta) / (2 (m - 1)))

with u_t the share of the step's task draws (drawn with replacement, as the
JAX learner draws them, also for the full batch), KL_out the closed-form
KL of the hyper-posterior to the hyper-prior times ``meta_kl_weight``, and
KL_in,t the mean over ``svi_batch_size`` samples of the KL of q_t to the GP
prior of the sample, times ``task_kl_weight``. The meta-complexity uses the
paper's parenthesisation, as the JAX package does.

Meta-testing fits fresh per-task posteriors to the context sets (3000 Adam
steps at lr 1e-2, the hyper-posterior and the noise frozen), each started
at the moment-matched aggregation of 20 hyper-posterior samples; the
predictive is the sparse-GP predictive under that aggregated prior.

Two paths, as in the JAX package:

- the fused path: a configuration in the fused window (``_fused_path_ok``:
  diagonal posterior, NN mean + NN kernel of one hidden width, feature_dim
  1, svi_batch_size * width <= 1024, tasks of N <= 8 points, Adam, and the
  kernel's own fit test) runs its whole fit through the fused kernel B8
  (ops/cuda/fused_mlap_kernel.py), one launch per 512 steps and staircase
  step; the meta-test runs through the same kernel in meta-test mode when
  its context sets lie in the window (Adam is its optimizer either way);
- the general step, one Python loop iteration per step: the loss by
  ``_loss`` (the inner KLs through ``ops.variational.gaussian_kl_chol``),
  its gradient by autograd, and the two-group Adam (or SGD) update here,
  with the staircase lr of ops/launch_sched.py.

The noise of global step s is the [S, P] standard normals drawn on the
learner's device from a generator seeded with (train seed, s), and the task
draws of step s come from a CPU generator seeded the same way; both paths
take the same draws, so they follow one random trajectory and do not depend
on how the steps are chunked. A meta-test call draws its noise in blocks of
512 steps from a seed of its own. ``_stacked_step`` is the general step of S
fits stacked on a leading axis (``parallel.fit_models_parallel``), each with
its own draws.

``mesh=`` (a ``parallel.make_mesh`` mesh, full batch only) shards the tasks
over the mesh's "task" axis, as the JAX learner's: each rank holds its
tasks' data and per-task posteriors (q_means, q_trils and their moments),
the hyper-posterior and the noise stay whole on every rank. A rank's loss
is its tasks' share of the bound (the weights u_t of the whole draw; the
meta-complexity on the axis's first rank only), and an all_reduce sums the
gradients of the replicated leaves. The meta-test's tasks are sharded too
where their count divides the axis, and gathered afterwards; ``state_dict``
gathers the sharded leaves. The fused kernel's fit is off under a mesh.
"""

import math
import time

import numpy as np
import torch

from meta_learning_pacoh_torch import config
from meta_learning_pacoh_torch.algos.base import (
    RegressionModelMetaLearned,
    TaskShard,
    check_choice,
)
from meta_learning_pacoh_torch.interop import from_jax_mlap_state
from meta_learning_pacoh_torch.models.gp_base import broadcast_data, gp_gram, gp_mean
from meta_learning_pacoh_torch.models.random_gp import (
    init_posterior,
    make_hyper_prior,
    posterior_kl_to_prior,
    posterior_rsample,
    random_gp_config,
)
from meta_learning_pacoh_torch.ops import cuda, launch_sched
from meta_learning_pacoh_torch.ops.chol import safe_cholesky
from meta_learning_pacoh_torch.ops.cuda.fused_mlap_kernel import (
    Q_KEYS,
    FusedMLAPMetaTest,
    FusedMLAPTrainer,
    fused_mlap_fits,
)
from meta_learning_pacoh_torch.ops.distributions import (
    AffineTransformed,
    MultivariateNormal,
    Normal,
)
from meta_learning_pacoh_torch.ops.kernels import inv_softplus, per_seed, softplus
from meta_learning_pacoh_torch.ops.metrics import gp_eval_metrics
from meta_learning_pacoh_torch.ops.variational import (
    expected_log_prob_gaussian,
    gaussian_kl_chol,
    svgp_predict,
)
from meta_learning_pacoh_torch.parallel import mesh as mesh_ops
from meta_learning_pacoh_torch.utils.input_handling import handle_input_dim
from meta_learning_pacoh_torch.utils.profiling import (
    LEARNER_EVAL,
    LEARNER_GATE,
    LEARNER_INIT,
    LEARNER_META_FIT,
    LEARNER_META_TEST,
    OPS_PREDICTIVE,
    span,
    spanned,
)

N_AGG_SAMPLES = 20  # hyper-posterior samples of the aggregated prior
META_TEST_BLOCK = FusedMLAPMetaTest.MAX_LAUNCH  # steps of one meta-test noise block
_HYPER_KEYS = ("loc", "log_scale", "tril_raw")


def _seeds(seed, n):
    """n child seeds of ``seed`` (Python ints)."""
    return [int(s) for s in np.random.SeedSequence([seed]).generate_state(n)]


class GPRegressionMetaLearnedPAC(RegressionModelMetaLearned):

    @spanned(LEARNER_INIT)
    def __init__(self, meta_train_data, num_iter_fit=40000, feature_dim=1,
                 weight_prior_std=0.5, bias_prior_std=3.0, delta=0.1, task_kl_weight=1.0,
                 meta_kl_weight=1.0, posterior_lr_multiplier=1.0, covar_module="SE",
                 mean_module="zero", mean_nn_layers=(32, 32), kernel_nn_layers=(32, 32),
                 optimizer="Adam", lr=1e-3, lr_decay=1.0, svi_batch_size=5, cov_type="diag",
                 task_batch_size=-1, likelihood_noise_init=0.01, normalize_data=True,
                 random_seed=None, mesh=None, device=None):
        """mesh: a ``parallel.make_mesh`` mesh with a "task" axis, of the
        learner's device type; requires task_batch_size=-1 (full batch).
        device: where the state, the data and the computation live ('cuda',
        'cpu', a torch.device); None means the card, and raises without one."""
        super().__init__(normalize_data, random_seed, device)
        # the RandomGP flavour has NN or constant means; 'zero' is a constant
        # mean started (and hyper-prior-centred) at zero
        if mean_module == "zero":
            mean_module = "constant"
        check_choice("mean_module", mean_module, ("NN", "constant"))
        check_choice("covar_module", covar_module, ("NN", "SE"))
        check_choice("optimizer", optimizer, ("Adam", "SGD"))
        check_choice("cov_type", cov_type, ("diag", "full"))

        self.num_iter_fit = num_iter_fit
        self.delta = delta
        self.task_kl_weight, self.meta_kl_weight = task_kl_weight, meta_kl_weight
        self.svi_batch_size = svi_batch_size
        self.lr = lr
        self._optimizer_name, self._lr_decay = optimizer, lr_decay
        self._posterior_lr_multiplier = posterior_lr_multiplier
        self._cov_type = cov_type
        self._weight_prior_std, self._bias_prior_std = weight_prior_std, bias_prior_std

        self._check_and_set_dims(meta_train_data)
        self._compute_normalization_stats(meta_train_data)
        self.X, self.Y, self.mask = self._prepare_meta_data(meta_train_data)
        self.n_tasks = self.X.shape[0]
        self.task_batch_size = (self.n_tasks if task_batch_size < 1
                                else min(task_batch_size, self.n_tasks))

        self.cfg = random_gp_config(
            self.input_dim, feature_dim=feature_dim, mean_module=mean_module,
            covar_module=covar_module, mean_nn_layers=mean_nn_layers,
            kernel_nn_layers=kernel_nn_layers)
        self.hyper_prior = make_hyper_prior(self.cfg, weight_prior_std=weight_prior_std,
                                            bias_prior_std=bias_prior_std, device=self.device)
        post = init_posterior(self._generator, self.hyper_prior.dim, cov_type=cov_type,
                              device=self.device)
        q_means, q_trils = self._init_task_posteriors(post, self.X, self.mask,
                                                      self._next_seed())
        # the state: the hyper-posterior's leaves, the noise and the posteriors
        self.params = {**post, "raw_noise": inv_softplus(likelihood_noise_init - 1e-4).to(
            self.device), "q_means": q_means, "q_trils": q_trils}
        # the per-task posteriors start from the whole task set's draws, then
        # ride their tasks' shard
        self._shard_tasks(mesh, self.task_batch_size == self.n_tasks)
        if self._shard is not None:
            for k in Q_KEYS:
                (self.params[k],) = self._shard.take(self.params[k])
        self._train_seed = self._next_seed() % 2 ** 31
        self._eps_gen = torch.Generator(device=self.device)
        self._mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self._nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self._adam_count = 0
        self._step_count = 0
        self._fused = None  # the fused kernel's FusedMLAPTrainer, built at the first fused fit

    def _next_seed(self):
        return int(torch.randint(0, 2 ** 62, (1,), generator=self._generator))

    def _post(self, params):
        """The hyper-posterior's leaves of a state dict."""
        return {k: params[k] for k in _HYPER_KEYS if k in params}

    # ----------------------------------------------------------------- model
    def _prior_moments(self, theta, x, mask=None):
        """The moment-matched GP prior of the hyper-posterior samples theta
        [S, P] at the points x [..., N, D] -> (mean [..., N], cov [..., N, N]);
        a padded point (mask 0) gets mean 0 and an identity row."""
        s = theta.shape[0]
        p = self.hyper_prior.unravel(theta)
        xs = x.expand(s, *x.shape)
        means = gp_mean(self.cfg, p, xs)
        covs = gp_gram(self.cfg, p, xs)
        mean = torch.mean(means, dim=0)
        resid = means - mean
        eye = torch.eye(x.shape[-2], dtype=x.dtype, device=x.device)
        cov = (torch.mean(covs, dim=0)
               + torch.mean(resid[..., :, None] * resid[..., None, :], dim=0) + 1e-5 * eye)
        if mask is not None:
            mean = mean * mask
            cov = cov * (mask[..., :, None] * mask[..., None, :]) + torch.diag_embed(1.0 - mask)
        return mean, cov

    def _init_q(self, theta, eps, X, mask):
        """Per-task posteriors at the aggregated prior of theta [S, P] at X
        [T, N, D]: q_means = mean + 1e-3 eps * mask, q_trils = chol(cov + 1e-3 I)."""
        mean, cov = self._prior_moments(theta, X, mask)
        eye = torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
        return mean + 1e-3 * eps * mask, safe_cholesky(cov + 1e-3 * eye)

    @torch.no_grad()
    def _init_task_posteriors(self, post, X, mask, seed):
        """``_init_q`` at N_AGG_SAMPLES hyper-posterior samples, its noise drawn
        on the device from ``seed``."""
        s_theta, s_eps = _seeds(seed, 2)
        gen = torch.Generator(device=self.device).manual_seed(s_eps)
        eps = torch.randn(X.shape[:2], generator=gen, device=self.device)
        return self._init_q(posterior_rsample(post, self._agg_eps(s_theta)), eps, X, mask)

    def _task_bound(self, q_means, q_trils, X, Y, theta, noise_var, kl_outer, n_tasks, mask):
        """Every task's PAC bound term, [T] each of (bound, avg_ll, kl_inner);
        stacked (leading axis S on the state, the data, theta [S, M, P],
        noise_var and kl_outer [S]) [S, T] each.

        A padded point pins q to N(0, 1) and the prior to the identity there,
        so it adds exactly 0 to the expected log-likelihood and the inner KL."""
        m2 = mask[..., :, None] * mask[..., None, :]
        L = torch.tril(q_trils) * m2 + torch.diag_embed(1.0 - mask)
        q_mean_eff = q_means * mask
        f_var = torch.sum(L * L, dim=-1)
        n_eff = torch.sum(mask, dim=-1)
        lp = expected_log_prob_gaussian(Y, q_mean_eff, f_var, per_seed(noise_var, 3))
        avg_ll = torch.sum(lp * mask, dim=-1) / n_eff

        lead = theta.shape[:-1]  # (M,) samples, or (S, M)
        t, n = X.shape[-3], X.shape[-2]
        p = self.hyper_prior.unravel(theta.reshape(-1, theta.shape[-1]))
        xs = broadcast_data(X, lead, 3).reshape(-1, *X.shape[-3:])
        prior_mean = gp_mean(self.cfg, p, xs).reshape(*lead, t, n) * mask.unsqueeze(-3)
        prior_cov = (gp_gram(self.cfg, p, xs).reshape(*lead, t, n, n) * m2.unsqueeze(-4)
                     + torch.diag_embed(1.0 - mask).unsqueeze(-4))
        kl = gaussian_kl_chol(q_mean_eff.unsqueeze(-3), L.unsqueeze(-4), prior_mean,
                              prior_cov)  # [..., M, T]
        kl_inner = self.task_kl_weight * torch.mean(kl, dim=-2)
        complexity = torch.sqrt(
            (per_seed(kl_outer, 2) + kl_inner + math.log(2.0) + torch.log(n_eff)
             + math.log(n_tasks) - math.log(self.delta)) / (2.0 * (n_eff - 1.0)))
        return -avg_ll + complexity, avg_ll, kl_inner

    def _loss(self, params, eps, counts, X, Y, mask, meta_test=False):
        """(loss, diag) of one step: the count-weighted bound plus the
        meta-complexity, or in meta-test mode the sum of the bounds. The
        bound's task count is always the meta-train one. Stacked (leading
        axis S on the state, eps [S, M, P], counts [S, T]): [S] each."""
        post = self._post(params)
        theta = posterior_rsample(post, eps)
        kl_outer = self.meta_kl_weight * posterior_kl_to_prior(post, self.hyper_prior)
        noise_var = softplus(params["raw_noise"]) + 1e-4
        bounds, avg_lls, kl_inners = self._task_bound(
            params["q_means"], params["q_trils"], X, Y, theta, noise_var, kl_outer,
            float(self.n_tasks), mask)
        if meta_test:
            return torch.sum(bounds), {}
        u = counts / torch.sum(counts, dim=-1, keepdim=True)
        drawn = counts > 0  # a never-drawn task adds exactly 0, even if its bound is not finite
        if self._shard is not None:  # this rank's tasks of the whole draw
            u, drawn = self._shard.take(u, drawn)
        meta_complexity = torch.sqrt(
            (kl_outer + math.log(2.0) + math.log(float(self.n_tasks)) - math.log(self.delta))
            / (2.0 * (self.n_tasks - 1.0)))
        loss = torch.sum(torch.where(drawn, u * bounds, 0.0), dim=-1)
        if self._shard is None or self._shard.lead:
            loss = loss + meta_complexity
        diag = {"avg_ll": torch.sum(torch.where(drawn, u * avg_lls, 0.0), dim=-1),
                "kl_outer_weighted": kl_outer,
                "kl_inner_weighted": torch.sum(torch.where(drawn, u * kl_inners, 0.0), dim=-1)}
        return loss, diag

    # ------------------------------------------------------------ train step
    def _task_draw(self, step):
        """Task indices (a CPU tensor) of global step ``step``, drawn with replacement."""
        seed = int(np.random.SeedSequence([self._train_seed, step]).generate_state(1)[0])
        gen = torch.Generator().manual_seed(seed)
        return torch.randint(0, self.n_tasks, (self.task_batch_size,), generator=gen)

    def _draw_eps(self, step, out):
        """Fill ``out`` [S, P] (on the learner's device) with the standard
        normals of global step ``step``."""
        seed = int(np.random.SeedSequence([self._train_seed, step]).generate_state(2)[1])
        out.normal_(generator=self._eps_gen.manual_seed(seed))

    def _update(self, params, grads, keys, lr_main, lr_post, mu, nu, count):
        """The two-group update: lr_main on the hyper-posterior and the noise,
        lr_post on the per-task posteriors; Adam at step ``count`` or SGD.
        The lrs are numbers, or [S] (one value a stacked fit)."""
        with torch.no_grad():
            for k, g in zip(keys, grads):
                lr = per_seed(lr_post if k in Q_KEYS else lr_main, params[k].dim())
                if self._optimizer_name == "SGD":
                    params[k].sub_(lr * g)
                else:
                    cuda.adam_step_(params[k], mu[k], nu[k], g, count, lr)

    def _post_lr(self):
        """The per-task posteriors' initial lr."""
        return self.lr * self._posterior_lr_multiplier

    def _draws(self, step):
        """(counts [T] on the device, eps [S, P]) of global step ``step``."""
        counts = torch.bincount(self._task_draw(step),
                                minlength=self.n_tasks).float().to(self.device)
        eps = torch.empty(self.svi_batch_size, self.hyper_prior.dim, device=self.device)
        self._draw_eps(step, eps)
        return counts, eps

    def _grads(self, state, eps, counts, data):
        """(loss, diag, the gradients in ``state``'s key order) at state."""
        params = {k: v.detach().requires_grad_(True) for k, v in state.items()}
        loss, diag = self._loss(params, eps, counts, *data)
        grads = torch.autograd.grad(loss.sum(), list(params.values()))
        return loss.detach(), {k: v.detach() for k, v in diag.items()}, grads

    def _step(self):
        """One general step; returns (loss, diag) as device scalars."""
        counts, eps = self._draws(self._step_count)
        loss, diag, grads = self._grads(self.params, eps, counts, (self.X, self.Y, self.mask))
        if self._shard is not None:
            self._shard.all_reduce_(loss, diag["avg_ll"], diag["kl_inner_weighted"],
                                    *[g for k, g in zip(self.params, grads) if k not in Q_KEYS])
        if self._optimizer_name == "Adam":
            self._adam_count += 1
        self._update(self.params, grads, list(self.params),
                     launch_sched.staircase_lr(self.lr, self._lr_decay, self._step_count),
                     launch_sched.staircase_lr(self._post_lr(), self._lr_decay,
                                               self._step_count),
                     self._mu, self._nu, self._adam_count)
        self._step_count += 1
        return loss, diag

    def _stacked_step(self, stack):
        """One general step of S stacked fits (``parallel.seed_parallel.SeedStack``:
        each state leaf with a leading axis S, each fit with its own data,
        task draws and noise), in place; returns (losses [S], diag)."""
        counts, eps = zip(*(m._draws(stack.step) for m in stack.models))
        state = stack.state["params"]
        loss, diag, grads = self._grads(state, torch.stack(eps), torch.stack(counts),
                                        stack.data)
        if self._optimizer_name == "Adam":
            stack.adam_count += 1
        self._update(state, grads, list(state), stack.staircase("lr"),
                     stack.staircase(GPRegressionMetaLearnedPAC._post_lr),
                     stack.state["_mu"], stack.state["_nu"], stack.adam_count)
        stack.step += 1
        return loss, diag

    # ------------------------------------------------------------ fused path
    def _fused_window_ok(self, n_points):
        """The structural window of the fused kernel, in training and in the
        meta-test: the JAX learner's (pacoh_mlap.py:345-364)."""
        cfg = self.cfg
        hidden = tuple(cfg.mean_nn_layers)
        return (
            config.fused_enabled()
            and self._cov_type == "diag"
            and cfg.mean_module == "NN" and cfg.covar_module == "NN"
            and cfg.feature_dim == 1
            and hidden == tuple(cfg.kernel_nn_layers)
            and len(set(hidden)) == 1 and len(hidden) >= 1
            and self.svi_batch_size * hidden[0] <= 1024
            and n_points <= 8
        )

    @spanned(LEARNER_GATE)
    def _fused_path_ok(self):
        """Whether the fused kernel carries the fit: the JAX learner's gate
        (Adam in the window) and a configuration the kernel takes."""
        t, n, d = self.X.shape
        return (self._fused_window_ok(n) and self._optimizer_name == "Adam"
                and self._mesh is None
                and fused_mlap_fits(self.svi_batch_size, t, n, d, self.cfg.mean_nn_layers))

    @spanned(LEARNER_GATE)
    def _fused_meta_test_ok(self, n_tasks, n_points, dim):
        """Whether the kernel's meta-test mode carries the inference of
        ``n_tasks`` posteriors of ``n_points`` points in ``dim`` dimensions:
        the JAX learner's meta-test gate (its ``_fused_window_ok``,
        pacoh_mlap.py:622) and a configuration the kernel takes."""
        return self._fused_window_ok(n_points) and fused_mlap_fits(
            self.svi_batch_size, n_tasks, n_points, dim, self.cfg.mean_nn_layers)

    def _fused_run_chunk(self, chunk):
        """``chunk`` steps through the fused kernel from the live state and Adam
        moments (so a fit may resume after general steps). Returns (last
        loss, the last step's diag) as device scalars."""
        if self._fused is None:
            self._fused = FusedMLAPTrainer(
                self.X, self.Y, self.mask, hidden=tuple(self.cfg.mean_nn_layers), lr=self.lr,
                posterior_lr_multiplier=self._posterior_lr_multiplier,
                svi_batch_size=self.svi_batch_size, task_batch_size=self.task_batch_size,
                task_kl_weight=self.task_kl_weight, meta_kl_weight=self.meta_kl_weight,
                delta=self.delta, weight_prior_std=self._weight_prior_std,
                bias_prior_std=self._bias_prior_std, eps_draw=self._draw_eps,
                task_draw=self._task_draw, lr_decay=self._lr_decay)
        last, _ = self._fused.run(self.params, self._mu, self._nu, chunk, self._step_count)
        self._step_count += chunk
        self._adam_count += chunk
        return last, self._fused.last_diag

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @spanned(LEARNER_META_FIT)
    def meta_fit(self, valid_tuples=None, verbose=True, log_period=500, eval_period=5000,
                 n_iter=None):
        """Trains the hyper-posterior, the noise and the per-task posteriors on
        the PAC bound. Returns (last loss, the last step's diag) as floats."""
        if valid_tuples is not None and not all(len(t) == 4 for t in valid_tuples):
            raise ValueError("valid tuples must be (ctx_x, ctx_y, test_x, test_y)")
        n_iter = self.num_iter_fit if n_iter is None else n_iter
        want_metrics = verbose or valid_tuples is not None
        use_fused = self._fused_path_ok()
        t = time.time()
        done, last, diag = 0, None, {}
        while done < n_iter:
            chunk = int(min(log_period, n_iter - done))
            if use_fused:
                last, diag = self._fused_run_chunk(chunk)
            else:
                for _ in range(chunk):
                    last, diag = self._step()
            done += chunk
            if want_metrics:
                self._sync()
                duration, t = time.time() - t, time.time()
                message = "Iter %d/%d - Loss: %.6f - Time %.2f sec - " % (
                    done, n_iter, float(last), duration)
                if valid_tuples is not None and done % eval_period == 0:
                    valid_ll, valid_rmse, calib = self.eval_datasets(valid_tuples)
                    message += (" - Valid-LL: %.3f - Valid-RMSE: %.3f - Calib-Err %.3f - "
                                % (valid_ll, valid_rmse, calib))
                message += " - ".join("%s: %.4f" % (k, float(v)) for k, v in diag.items())
                if verbose:
                    self.logger.info(message)
        self.fitted = True
        loss = float("nan") if last is None else float(last)
        return loss, {k: float(v) for k, v in diag.items()}

    # ------------------------------------------------------------- meta-test
    def _meta_test_eps(self, seed, step0, n_steps):
        """[n_steps, S, P] noise of the meta-test block starting at ``step0``."""
        block_seed = int(np.random.SeedSequence([seed, step0]).generate_state(1)[0])
        gen = torch.Generator(device=self.device).manual_seed(block_seed)
        return torch.randn(n_steps, self.svi_batch_size, self.hyper_prior.dim, generator=gen,
                           device=self.device)

    def _agg_eps(self, seed):
        """[N_AGG_SAMPLES, P] standard normals of the aggregated prior's samples."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn(N_AGG_SAMPLES, self.hyper_prior.dim, generator=gen,
                           device=self.device)

    def _meta_test_general(self, params, Xc, Yc, Mc, n_iter, lr, eps_block):
        """The meta-test's inference by autograd: Adam at ``lr`` on q_means and
        q_trils of ``params`` (updated in place), the rest frozen."""
        mu = {k: torch.zeros_like(params[k]) for k in Q_KEYS}
        nu = {k: torch.zeros_like(params[k]) for k in Q_KEYS}
        frozen = {k: v.detach() for k, v in params.items() if k not in Q_KEYS}
        for s0, sub in launch_sched.staircase_launches(0, n_iter, META_TEST_BLOCK):
            eps = eps_block(s0, sub)
            for i in range(sub):
                q = {k: params[k].detach().requires_grad_(True) for k in Q_KEYS}
                with torch.enable_grad():
                    loss, _ = self._loss({**frozen, **q}, eps[i], None, Xc, Yc, Mc,
                                         meta_test=True)
                    grads = torch.autograd.grad(loss, [q[k] for k in Q_KEYS])
                with torch.no_grad():
                    for k, g in zip(Q_KEYS, grads):
                        cuda.adam_step_(params[k], mu[k], nu[k], g, s0 + i + 1, lr)

    @spanned(LEARNER_META_TEST)
    @torch.no_grad()
    def _meta_test_inference(self, context_tuples, n_iter=3000, lr=1e-2):
        """Fit per-task posteriors to the context sets (ragged ones padded and
        masked), all in one inference; returns the task state that the
        predictive needs."""
        Xc, Yc, Mc = self._prepare_meta_data(context_tuples)
        t, n, d = Xc.shape
        s_init, s_opt, s_theta = _seeds(self._next_seed(), 3)
        post = self._post(self.params)
        theta_agg = posterior_rsample(post, self._agg_eps(s_theta))
        q_means, q_trils = self._init_task_posteriors(post, Xc, Mc, s_init)
        shard, data = None, (Xc, Yc, Mc)
        if self._mesh is not None and t % mesh_ops.axis_size(self._mesh, "task") == 0:
            # the tasks' inferences are independent: each rank runs its share
            shard = TaskShard(self._mesh, Mc)
            data = shard.take(Xc, Yc, Mc)
            q_means, q_trils = shard.take(q_means, q_trils)
            t = t // mesh_ops.axis_size(self._mesh, "task")
        params = {**post, "raw_noise": self.params["raw_noise"], "q_means": q_means,
                  "q_trils": q_trils}

        def eps_block(step0, n_steps):
            return self._meta_test_eps(s_opt, step0, n_steps)

        if self._fused_meta_test_ok(t, n, d):
            FusedMLAPMetaTest(
                *data, hidden=tuple(self.cfg.mean_nn_layers), lr=lr,
                task_kl_weight=self.task_kl_weight, meta_kl_weight=self.meta_kl_weight,
                delta=self.delta, n_tasks=self.n_tasks, weight_prior_std=self._weight_prior_std,
                bias_prior_std=self._bias_prior_std).run(params, n_iter, eps_block)
        else:
            self._meta_test_general(params, *data, n_iter, lr, eps_block)
        if shard is not None:
            for k in Q_KEYS:
                params[k] = shard.gather(params[k])
        return {"Xc": Xc, "Mc": Mc, "q_means": params["q_means"], "q_trils": params["q_trils"],
                "theta_agg": theta_agg}

    @spanned(OPS_PREDICTIVE)
    def _predictive(self, task_state, TX):
        """Predictive moments in normalised space at the test points TX
        [T, Nt, D] of the tasks of ``task_state`` -> (mean [T, Nt], cov [T, Nt, Nt])."""
        Xc, Mc = task_state["Xc"], task_state["Mc"]
        nc = Xc.shape[1]
        x_all = torch.cat([Xc, TX], dim=1)
        mask_all = torch.cat([Mc, torch.ones(TX.shape[:2], dtype=Mc.dtype, device=Mc.device)],
                             dim=1)
        mean_all, cov_all = self._prior_moments(task_state["theta_agg"], x_all, mask_all)
        m2c = Mc[..., :, None] * Mc[..., None, :]
        q_tril = torch.tril(task_state["q_trils"]) * m2c + torch.diag_embed(1.0 - Mc)
        m, c = svgp_predict(task_state["q_means"] * Mc, q_tril, mean_all[:, :nc],
                            cov_all[:, :nc, :nc], cov_all[:, :nc, nc:], mean_all[:, nc:],
                            cov_all[:, nc:, nc:])
        noise_var = softplus(self.params["raw_noise"]) + 1e-4
        eye = torch.eye(c.shape[-1], dtype=c.dtype, device=c.device)
        return m, c + noise_var * eye

    def _run_batch_eval(self, task_state, TX, TY):
        """(ll [T], rmse [T], calib [T]) of all test tasks in one batched call:
        TX [T, Nt, D] normalised, TY [T, Nt] in original units."""
        m, c = self._predictive(task_state, TX)
        return gp_eval_metrics(m, c, TY, float(self.y_mean[0]), float(self.y_std[0]))

    @torch.no_grad()
    def predict(self, context_x, context_y, test_x, n_iter_meta_test=3000,
                return_density=False):
        """Predictive at test_x in original y units after a meta-test of
        ``n_iter_meta_test`` steps on the context set."""
        context_x, context_y = handle_input_dim(context_x, context_y)
        test_x = handle_input_dim(test_x)
        if test_x.shape[1] != context_x.shape[1]:
            raise ValueError("test_x and context_x differ in input dimension")
        task_state = self._meta_test_inference([(context_x, context_y)], n_iter=n_iter_meta_test)
        mean, cov = self._predictive(task_state, self._tensor(self._normalize_x(test_x))[None])
        pred_dist = AffineTransformed(MultivariateNormal(mean[0], cov[0]), self.y_mean[0],
                                      self.y_std[0])
        if return_density:
            return pred_dist
        return pred_dist.mean.cpu().numpy(), pred_dist.stddev.cpu().numpy()

    @torch.no_grad()
    def eval_datasets(self, test_tuples, n_iter_meta_test=3000, **kwargs):
        """Mean (ll, rmse, calib) over (ctx_x, ctx_y, test_x, test_y) tuples: one
        meta-test inference for all context sets, then the metrics of all
        tasks in one batched call (tasks with test sets of other sizes one by
        one). Other keyword arguments are accepted and unused, as in the JAX
        learner."""
        if not all(len(t) == 4 for t in test_tuples):
            raise ValueError("test tuples must be (ctx_x, ctx_y, test_x, test_y)")
        task_state = self._meta_test_inference([t[:2] for t in test_tuples],
                                               n_iter=n_iter_meta_test)
        with span(LEARNER_EVAL):
            prepared = [handle_input_dim(tx, ty) for _, _, tx, ty in test_tuples]
            if len({tx.shape for tx, _ in prepared}) == 1:
                TX = self._tensor(np.stack([self._normalize_x(tx) for tx, _ in prepared]))
                TY = self._tensor(np.stack([ty[:, 0] for _, ty in prepared]))
                lls, rmses, calibs = self._run_batch_eval(task_state, TX, TY)
                return (float(torch.mean(lls)), float(torch.mean(rmses)),
                        float(torch.mean(calibs)))
            results = []
            for i, (tx, ty) in enumerate(prepared):
                one = {k: v[i:i + 1] if k != "theta_agg" else v for k, v in task_state.items()}
                results.append(self._run_batch_eval(
                    one, self._tensor(self._normalize_x(tx))[None],
                    self._tensor(ty[:, 0])[None]))
            ll, rmse, calib = (float(torch.mean(torch.cat(r))) for r in zip(*results))
            return ll, rmse, calib

    @torch.no_grad()
    def prior_mean(self, x, n_hyperposterior_samples=1000):
        """The aggregated prior's mean curve at x, in original units."""
        x = handle_input_dim(np.asarray(x))
        xn = self._tensor(self._normalize_x(x))
        theta = posterior_rsample(self._post(self.params), torch.randn(
            n_hyperposterior_samples, self.hyper_prior.dim,
            generator=torch.Generator(device=self.device).manual_seed(self._next_seed()),
            device=self.device))
        means = gp_mean(self.cfg, self.hyper_prior.unravel(theta),
                        xn.expand(n_hyperposterior_samples, *xn.shape))
        return torch.mean(means, dim=0).cpu().numpy() * self.y_std[0] + self.y_mean[0]

    def _vectorize_pred_dist(self, pred_dist):
        return Normal(pred_dist.mean, pred_dist.stddev)

    # ------------------------------------------------------------ checkpoint
    def state_dict(self):
        """{'params', 'opt_state': {'mu', 'nu', 'count'}, 'step'}, the params and
        moments nested as the JAX learner's: {'hyper_post': {...}, 'raw_noise',
        'q_means', 'q_trils'}. Under a mesh, every rank gathers the sharded
        leaves (a collective: all ranks call it)."""
        def nest(tree):  # copies: the fit updates the state in place
            tree = {k: (self._shard.gather(v) if self._shard is not None and k in Q_KEYS else v)
                    for k, v in tree.items()}
            flat = {k: v.detach().cpu().numpy().copy() for k, v in tree.items()}
            return {"hyper_post": {k: flat.pop(k) for k in _HYPER_KEYS if k in flat}, **flat}

        return {"params": nest(self.params),
                "opt_state": {"mu": nest(self._mu), "nu": nest(self._nu),
                              "count": self._adam_count},
                "step": self._step_count}

    def load_state_dict(self, state_dict):
        """Restore a state of this class or a JAX learner's ``state_dict()``
        (all tasks' posteriors; under a mesh each rank keeps its shard)."""
        if not isinstance(state_dict["opt_state"], dict):
            state_dict = from_jax_mlap_state(state_dict)

        def flat(tree):
            leaves = {**tree["hyper_post"], **{k: v for k, v in tree.items()
                                               if k != "hyper_post"}}
            leaves = {k: self._tensor(v) for k, v in leaves.items()}
            if self._shard is not None:
                for k in Q_KEYS:
                    (leaves[k],) = self._shard.take(leaves[k])
            return leaves

        self.params = flat(state_dict["params"])
        opt = state_dict["opt_state"]
        self._mu, self._nu = flat(opt["mu"]), flat(opt["nu"])
        self._adam_count = int(opt["count"])
        self._step_count = int(state_dict.get("step", 0))
