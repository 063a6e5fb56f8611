"""PACOH-VI: a Gaussian variational hyper-posterior over GP-prior parameters
(counterpart of meta_learning_pacoh_tpu/algos/pacoh_vi.py).

The posterior q is N(loc, diag(exp(log_scale))^2) (``cov_type="diag"``) or a
full covariance with scale_tril from ``tril_raw``, its diagonal in log space
(models/random_gp.py). The fit minimises the negative ELBO

    -( mean_s meta_log_prob(sample_s) + prior_factor * H(q) )

over ``svi_batch_size`` reparameterised samples a step by Adam or SGD, with
the staircase lr schedule of ops/launch_sched.py. Prediction is Bayes (an
equal-weight mixture over posterior samples) or MAP (the GP at ``loc``).

Two paths, as in the JAX package:

- the fused path: a configuration in the fused window (``_fused_path_ok``:
  diagonal posterior, NN mean + NN kernel of one hidden width, feature_dim
  1, Adam, full batch or a sampled batch of uniform task sizes) runs its
  whole fit through a fused training kernel, one launch per 512 steps and
  staircase step: tasks of N <= 8 points through ops/cuda/fused_vi_kernel.py
  (B7), of 9 <= N <= 256 through ops/cuda/fused_vi_bign_kernel.py (B11, by
  default where the H100's faceoff measured it to win, unlike the TPU's
  policy: ``fused_svgd_bign_kernel.bign_wins``);
- the general step, one Python loop iteration per step: the negative ELBO
  by ``neg_elbo``, its gradient by autograd, and the update here.

The noise of global step s is the [S, P] standard normals drawn on the
learner's device from a generator seeded with (train seed, s), and a sampled
task batch draws its tasks from a CPU generator seeded the same way,
weighting each task's MLL by its draw count (the JAX learner's
count-weighted mode, ``PACOH_TPU_VI_WEIGHTED=1``). Both paths take the same
draws, so they follow one random trajectory and do not depend on how the
steps are chunked. ``_stacked_step`` is the general step of S fits stacked
on a leading axis (``parallel.fit_models_parallel``,
``utils.tuning_parallel``), each with its own draws.

``mesh=`` (a ``parallel.make_mesh`` mesh, full batch only) shards the tasks
over the mesh's "task" axis, as the JAX learner's: each rank takes its
tasks' share of the negative ELBO (the hyper-prior and entropy terms on
the axis's first rank only), an all_reduce sums the gradients, and every
rank applies the same update to its copy of the posterior. Every rank
draws the same noise (the generator of (train seed, s) on its device).
The fused kernels are off under a mesh.
"""

import time

import numpy as np
import torch

from meta_learning_pacoh_torch import config
from meta_learning_pacoh_torch.algos.base import RegressionModelMetaLearned, check_choice
from meta_learning_pacoh_torch.interop import from_jax_vi_state
from meta_learning_pacoh_torch.models.gp_base import gp_predict
from meta_learning_pacoh_torch.models.random_gp import (
    init_posterior,
    make_hyper_prior,
    neg_elbo,
    posterior_rsample,
    random_gp_config,
)
from meta_learning_pacoh_torch.ops import cuda, launch_sched
from meta_learning_pacoh_torch.ops.cuda.fused_svgd_bign_kernel import bign_wins
from meta_learning_pacoh_torch.ops.cuda.fused_vi_bign_kernel import FusedVIBigNTrainer, vi_bign_fits
from meta_learning_pacoh_torch.ops.cuda.fused_vi_kernel import FusedVITrainer, fused_vi_fits
from meta_learning_pacoh_torch.ops.distributions import (
    AffineTransformed,
    EqualWeightedMixture,
    MultivariateNormal,
    Normal,
)
from meta_learning_pacoh_torch.ops.kernels import per_seed
from meta_learning_pacoh_torch.ops.metrics import mixture_eval_metrics
from meta_learning_pacoh_torch.utils.input_handling import handle_input_dim


class GPRegressionMetaLearnedVI(RegressionModelMetaLearned):

    def __init__(self, meta_train_data, num_iter_fit=10000, feature_dim=1,
                 prior_factor=0.01, weight_prior_std=0.5, bias_prior_std=3.0,
                 covar_module="NN", mean_module="NN", mean_nn_layers=(32, 32),
                 kernel_nn_layers=(32, 32), optimizer="Adam", lr=1e-3, lr_decay=1.0,
                 svi_batch_size=10, cov_type="diag", task_batch_size=-1,
                 normalize_data=True, random_seed=None, mesh=None, device=None):
        """mesh: a ``parallel.make_mesh`` mesh with a "task" axis, of the
        learner's device type; requires task_batch_size=-1 (full batch).
        device: where the posterior, the data and the computation live
        ('cuda', 'cpu', a torch.device); None means the card, and raises
        without one."""
        super().__init__(normalize_data, random_seed, device)
        check_choice("mean_module", mean_module, ("NN", "constant"))
        check_choice("covar_module", covar_module, ("NN", "SE"))
        check_choice("optimizer", optimizer, ("Adam", "SGD"))
        check_choice("cov_type", cov_type, ("diag", "full"))

        self.num_iter_fit = num_iter_fit
        self.prior_factor = prior_factor
        self.svi_batch_size = svi_batch_size
        self._cov_type = cov_type
        self._optimizer_name, self._lr, self._lr_decay = optimizer, lr, lr_decay
        self._weight_prior_std, self._bias_prior_std = weight_prior_std, bias_prior_std

        self._check_and_set_dims(meta_train_data)
        self._compute_normalization_stats(meta_train_data)
        self.X, self.Y, self.mask = self._prepare_meta_data(meta_train_data)
        self.n_tasks = self.X.shape[0]
        self.task_batch_size = (self.n_tasks if task_batch_size < 1
                                else min(task_batch_size, self.n_tasks))
        self._shard_tasks(mesh, self.task_batch_size == self.n_tasks)

        self.cfg = random_gp_config(
            self.input_dim, feature_dim=feature_dim, mean_module=mean_module,
            covar_module=covar_module, mean_nn_layers=mean_nn_layers,
            kernel_nn_layers=kernel_nn_layers)
        self.hyper_prior = make_hyper_prior(self.cfg, weight_prior_std=weight_prior_std,
                                            bias_prior_std=bias_prior_std, device=self.device)
        self.posterior = init_posterior(self._generator, self.hyper_prior.dim,
                                        cov_type=cov_type, device=self.device)
        # the draws of step s come from generators seeded with (train seed, s),
        # so they do not depend on how the steps are chunked
        self._train_seed = int(torch.randint(0, 2 ** 31, (1,), generator=self._generator))
        self._eps_gen = torch.Generator(device=self.device)
        self._mu = {k: torch.zeros_like(v) for k, v in self.posterior.items()}
        self._nu = {k: torch.zeros_like(v) for k, v in self.posterior.items()}
        self._adam_count = 0
        self._step_count = 0
        self._fused = None  # the fused kernel's FusedVITrainer, built at the first fused fit

    # ------------------------------------------------------------ train step
    def _task_draw(self, step):
        """Task indices (a CPU tensor) of the sampled batch of global step ``step``."""
        seed = int(np.random.SeedSequence([self._train_seed, step]).generate_state(1)[0])
        gen = torch.Generator().manual_seed(seed)
        return torch.randint(0, self.n_tasks, (self.task_batch_size,), generator=gen)

    def _draw_eps(self, step, out):
        """Fill ``out`` [S, P] (on the learner's device) with the standard
        normals of global step ``step``."""
        seed = int(np.random.SeedSequence([self._train_seed, step]).generate_state(2)[1])
        out.normal_(generator=self._eps_gen.manual_seed(seed))

    def _draws(self, step):
        """(counts [T] on the device or None for the full batch, eps [S, P])
        of global step ``step``."""
        counts = None
        if self.task_batch_size != self.n_tasks:
            idx = self._task_draw(step)
            counts = torch.bincount(idx, minlength=self.n_tasks).float().to(self.device)
        eps = torch.empty(self.svi_batch_size, self.hyper_prior.dim, device=self.device)
        self._draw_eps(step, eps)
        return counts, eps

    def _update_posterior(self, posterior, mu, nu, data, counts, eps, prior_factor, lr,
                          adam_count):
        """One general step on the posterior's leaves [..., P] (or [..., P, P])
        and their Adam moments, in place: the negative ELBO at noise eps, its
        gradient by autograd, then Adam (at step ``adam_count``) or SGD at
        lr, a number or [S] (one value a stacked fit). Returns the loss."""
        post = {k: v.detach().requires_grad_(True) for k, v in posterior.items()}
        loss = neg_elbo(self.hyper_prior, prior_factor, post, eps, *data, counts=counts,
                        **self._shard_terms())
        grads = torch.autograd.grad(loss.sum(), list(post.values()))
        loss = loss.detach()
        if self._shard is not None:
            self._shard.all_reduce_(loss, *grads)
        with torch.no_grad():
            for (k, v), g in zip(posterior.items(), grads):
                lr_k = per_seed(lr, v.dim())
                if self._optimizer_name == "SGD":
                    v.sub_(lr_k * g)
                else:
                    cuda.adam_step_(v, mu[k], nu[k], g, adam_count, lr_k)
        return loss

    def _step(self):
        """One general step; returns its loss (a device scalar)."""
        counts, eps = self._draws(self._step_count)
        lr = launch_sched.staircase_lr(self._lr, self._lr_decay, self._step_count)
        if self._optimizer_name == "Adam":
            self._adam_count += 1
        loss = self._update_posterior(self.posterior, self._mu, self._nu,
                                      (self.X, self.Y, self.mask), counts, eps,
                                      self.prior_factor, lr, self._adam_count)
        self._step_count += 1
        return loss

    def _stacked_step(self, stack):
        """One general step of S stacked fits (``parallel.seed_parallel.SeedStack``:
        leaves [S, P], each fit with its own data, task draws, noise,
        prior_factor and lr), in place; returns the losses [S]."""
        counts, eps = zip(*(m._draws(stack.step) for m in stack.models))
        counts = None if counts[0] is None else torch.stack(counts)
        if self._optimizer_name == "Adam":
            stack.adam_count += 1
        loss = self._update_posterior(
            stack.state["posterior"], stack.state["_mu"], stack.state["_nu"], stack.data,
            counts, torch.stack(eps), stack.per_seed("prior_factor"), stack.staircase("_lr"),
            stack.adam_count)
        stack.step += 1
        return loss

    # ------------------------------------------------------------ fused path
    def _fused_path_ok(self):
        """Whether a fused training kernel carries the fit: the JAX learner's
        gate (pacoh_vi.py:214-250), with its N <= 8 arm (B7) and its
        9 <= N <= 256 arm (B11, where the H100's faceoff measured it to win:
        ``bign_wins``, the counterpart of the JAX learner's
        ``svgd_bign_wins``), and a configuration the kernel takes."""
        cfg = self.cfg
        hidden = tuple(cfg.mean_nn_layers)
        sizes = torch.sum(self.mask, dim=-1)
        t, n, d = self.X.shape
        return (
            config.fused_enabled()
            and self._mesh is None
            and self._cov_type == "diag"
            # full batch, or sampled batches as count pages of uniform task sizes
            and (self.task_batch_size == self.n_tasks or bool(torch.all(sizes == sizes[0])))
            and self._optimizer_name == "Adam"
            and cfg.mean_module == "NN" and cfg.covar_module == "NN"
            and cfg.feature_dim == 1
            and hidden == tuple(cfg.kernel_nn_layers)
            and len(set(hidden)) == 1 and len(hidden) >= 1
            and self.svi_batch_size * hidden[0] <= 1024
            and (fused_vi_fits(self.svi_batch_size, t, n, d, hidden) if n <= 8
                 else (vi_bign_fits(self.svi_batch_size, t, n, d, hidden)
                       and bign_wins(self.svi_batch_size * t)))
        )

    def _fused_run_chunk(self, chunk):
        """``chunk`` steps through the fused kernel, from the live posterior
        and Adam moments (so a fit may resume after general steps). Returns
        (last loss, mean loss) as device scalars."""
        if self._fused is None:
            trainer_cls = FusedVITrainer if self.X.shape[1] <= 8 else FusedVIBigNTrainer
            self._fused = trainer_cls(
                self.X, self.Y, self.mask, hidden=tuple(self.cfg.mean_nn_layers), lr=self._lr,
                lr_decay=self._lr_decay, prior_factor=self.prior_factor,
                weight_prior_std=self._weight_prior_std, bias_prior_std=self._bias_prior_std,
                svi_batch_size=self.svi_batch_size, eps_draw=self._draw_eps,
                task_batch_size=self.task_batch_size, task_draw=self._task_draw)
        state = [d[k] for d in (self.posterior, self._mu, self._nu) for k in ("loc", "log_scale")]
        losses = self._fused.run(*state, chunk, self._step_count)
        self._step_count += chunk
        self._adam_count += chunk
        return losses

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def meta_fit(self, valid_tuples=None, verbose=True, log_period=500, n_iter=None):
        """Fits the variational hyper-posterior by minimising the negative ELBO.
        Returns the last step's loss."""
        if valid_tuples is not None and not all(len(t) == 4 for t in valid_tuples):
            raise ValueError("valid tuples must be (ctx_x, ctx_y, test_x, test_y)")
        n_iter = self.num_iter_fit if n_iter is None else n_iter
        want_metrics = verbose or valid_tuples is not None
        use_fused = self._fused_path_ok()
        t = time.time()
        done, last = 0, None
        while done < n_iter:
            chunk = int(min(log_period, n_iter - done))
            if use_fused:
                last, _ = self._fused_run_chunk(chunk)
            else:
                for _ in range(chunk):
                    last = self._step()
            done += chunk
            if want_metrics:
                self._sync()
                duration, t = time.time() - t, time.time()
                message = "Iter %d/%d - Loss: %.6f - Time %.2f sec" % (
                    done, n_iter, float(last), duration)
                if valid_tuples is not None:
                    valid_ll, valid_rmse, calib = self.eval_datasets(valid_tuples)
                    message += (" - Valid-LL: %.3f - Valid-RMSE: %.3f - Calib-Err %.3f"
                                % (valid_ll, valid_rmse, calib))
                if verbose:
                    self.logger.info(message)
        self.fitted = True
        return float("nan") if last is None else float(last)

    # --------------------------------------------------------------- predict
    def _posterior_eps(self, n_samples):
        """[n_samples, P] standard normals on the learner's device, from a
        generator seeded by the learner's own."""
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._generator))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn(n_samples, self.hyper_prior.dim, generator=gen, device=self.device)

    def _predict_moments(self, cx, cy, tx, flat):
        """Predictive moments in normalised space of the parameter sets flat
        [K, P]: cx [..., Nc, D], cy [..., Nc], tx [..., Nt, D] ->
        (means [K, ..., Nt], covs [K, ..., Nt, Nt])."""
        k = flat.shape[0]
        return gp_predict(self.cfg, self.hyper_prior.unravel(flat), cx.expand(k, *cx.shape), cy,
                          tx.expand(k, *tx.shape))

    @torch.no_grad()
    def _run_batch_eval(self, CX, CY, TX, TY, n_posterior_samples=100):
        # one shared set of posterior samples for all test tasks
        samples = posterior_rsample(self.posterior, self._posterior_eps(n_posterior_samples))
        means, covs = self._predict_moments(CX, CY, TX, samples)
        return mixture_eval_metrics(means, covs, TY, float(self.y_mean[0]),
                                    float(self.y_std[0]))

    @torch.no_grad()
    def predict(self, context_x, context_y, test_x, n_posterior_samples=100, mode="Bayes",
                return_density=False):
        """Posterior predictive in original y units: Bayes mode a mixture over
        ``n_posterior_samples`` posterior samples, MAP mode the GP at loc."""
        check_choice("mode", mode, ("bayes", "Bayes", "MAP", "map"))
        context_x, context_y = handle_input_dim(context_x, context_y)
        test_x = handle_input_dim(test_x)
        if test_x.shape[1] != context_x.shape[1]:
            raise ValueError("test_x and context_x differ in input dimension")
        cx, cy = self._prepare_data_per_task(context_x, context_y)
        tx = self._tensor(self._normalize_x(test_x))
        if mode.lower() == "bayes":
            samples = posterior_rsample(self.posterior, self._posterior_eps(n_posterior_samples))
            means, covs = self._predict_moments(cx, cy, tx, samples)
            pred_dist = EqualWeightedMixture(AffineTransformed(
                MultivariateNormal(means, covs), self.y_mean[0], self.y_std[0]))
        else:
            mean, cov = self._predict_moments(cx, cy, tx, self.posterior["loc"][None])
            pred_dist = AffineTransformed(MultivariateNormal(mean[0], cov[0]), self.y_mean[0],
                                          self.y_std[0])
        if return_density:
            return pred_dist
        return pred_dist.mean.cpu().numpy(), pred_dist.stddev.cpu().numpy()

    def _vectorize_pred_dist(self, pred_dist):
        if isinstance(pred_dist, EqualWeightedMixture):
            base = pred_dist.base
            return EqualWeightedMixture(Normal(base.mean, base.stddev))
        return Normal(pred_dist.mean, pred_dist.stddev)

    # ------------------------------------------------------------ checkpoint
    def state_dict(self):
        # copies: the fit updates the posterior and moments in place
        def numpy(tree):
            return {k: v.detach().cpu().numpy().copy() for k, v in tree.items()}

        return {"posterior": numpy(self.posterior),
                "opt_state": {"mu": numpy(self._mu), "nu": numpy(self._nu),
                              "count": self._adam_count},
                "step": self._step_count}

    def load_state_dict(self, state_dict):
        """Restore a state of this class or a JAX learner's ``state_dict()``."""
        if not isinstance(state_dict["opt_state"], dict):
            state_dict = from_jax_vi_state(state_dict)
        self.posterior = {k: self._tensor(v) for k, v in state_dict["posterior"].items()}
        opt = state_dict["opt_state"]
        self._mu = {k: self._tensor(v) for k, v in opt["mu"].items()}
        self._nu = {k: self._tensor(v) for k, v in opt["nu"].items()}
        self._adam_count = int(opt["count"])
        self._step_count = int(state_dict.get("step", 0))
