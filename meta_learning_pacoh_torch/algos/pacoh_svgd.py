"""PACOH-SVGD: Stein variational gradient descent on the PAC-optimal hyper-posterior
(counterpart of meta_learning_pacoh_tpu/algos/pacoh_svgd.py).

K particles in GP-prior parameter space. Each step: the score, the gradient
of log(hyper-prior^prior_factor x product of task MLLs), by autograd through
the batched MLL (the MLL kernel's backward for 9 <= N <= 48); the Stein
transport phi (the Stein kernel for the RBF median heuristic); then an Adam
or SGD step fed -phi, equal to ``optax.adam`` / ``optax.sgd`` with the
staircase lr schedule (lr * lr_decay ** (step // 1000)).

This is the JAX package's general step, one Python loop iteration per
step. Its single-launch fused training kernels (N <= 8, and the big-N one)
and the mesh-sharded path are not ported yet.
"""

import time

import numpy as np
import torch

from meta_learning_pacoh_torch.algos.base import RegressionModelMetaLearned
from meta_learning_pacoh_torch.interop import from_jax_state
from meta_learning_pacoh_torch.models.gp_base import gp_predict
from meta_learning_pacoh_torch.models.random_gp import (
    make_hyper_prior,
    meta_log_prob,
    random_gp_config,
)
from meta_learning_pacoh_torch.ops.distributions import (
    AffineTransformed,
    EqualWeightedMixture,
    MultivariateNormal,
)
from meta_learning_pacoh_torch.ops.metrics import mixture_eval_metrics
from meta_learning_pacoh_torch.ops.svgd import svgd_phi
from meta_learning_pacoh_torch.utils.input_handling import handle_input_dim

LR_TRANSITION_STEPS = 1000  # StepLR step size of the reference
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _check_choice(name, value, choices):
    if value not in choices:
        raise ValueError(f"{name} must be one of {choices}, got {value!r}")


class GPRegressionMetaLearnedSVGD(RegressionModelMetaLearned):

    def __init__(self, meta_train_data, num_iter_fit=10000, feature_dim=1,
                 prior_factor=0.01, weight_prior_std=0.5, bias_prior_std=3.0,
                 covar_module="NN", mean_module="NN", mean_nn_layers=(32, 32),
                 kernel_nn_layers=(32, 32), optimizer="Adam", lr=1e-3, lr_decay=1.0,
                 kernel="RBF", bandwidth=None, num_particles=10, task_batch_size=-1,
                 normalize_data=True, random_seed=None, device=None):
        """device: where the particles, the data and the computation live
        ('cpu', 'cuda', a torch.device); None means the CPU."""
        super().__init__(normalize_data, random_seed, device)
        _check_choice("mean_module", mean_module, ("NN", "constant"))
        _check_choice("covar_module", covar_module, ("NN", "SE"))
        _check_choice("optimizer", optimizer, ("Adam", "SGD"))
        _check_choice("kernel", kernel, ("RBF", "IMQ"))

        self.num_iter_fit = num_iter_fit
        self.prior_factor = prior_factor
        self.num_particles = num_particles
        self.svgd_kernel, self.bandwidth = kernel, bandwidth
        self._optimizer_name, self._lr, self._lr_decay = optimizer, lr, lr_decay

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
        self.particles = self.hyper_prior.sample(self._generator, (num_particles,))
        # task draws of step s come from a generator seeded with (train seed, s),
        # so they do not depend on how the steps are chunked
        self._train_seed = int(torch.randint(0, 2 ** 31, (1,), generator=self._generator))
        self._mu = torch.zeros_like(self.particles)
        self._nu = torch.zeros_like(self.particles)
        self._adam_count = 0
        self._step_count = 0

    # ------------------------------------------------------------ train step
    def _lr_at(self, step):
        if self._lr_decay < 1.0:
            return self._lr * self._lr_decay ** (step // LR_TRANSITION_STEPS)
        return self._lr

    def _task_batch(self):
        if self.task_batch_size == self.n_tasks:
            return self.X, self.Y, self.mask
        seed = int(np.random.SeedSequence([self._train_seed, self._step_count])
                   .generate_state(1)[0])
        gen = torch.Generator().manual_seed(seed)
        idx = torch.randint(0, self.n_tasks, (self.task_batch_size,), generator=gen)
        idx = idx.to(self.device)
        return self.X[idx], self.Y[idx], self.mask[idx]

    def _apply_update(self, grad):
        """One optax-equivalent Adam or SGD step on the particles, in place."""
        lr = self._lr_at(self._step_count)
        if self._optimizer_name == "SGD":
            self.particles.sub_(lr * grad)
            return
        self._mu = (1.0 - ADAM_B1) * grad + ADAM_B1 * self._mu
        self._nu = (1.0 - ADAM_B2) * grad * grad + ADAM_B2 * self._nu
        self._adam_count += 1
        mu_hat = self._mu / (1.0 - ADAM_B1 ** self._adam_count)
        nu_hat = self._nu / (1.0 - ADAM_B2 ** self._adam_count)
        self.particles.sub_(lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)))

    def _step(self):
        X, Y, M = self._task_batch()
        particles = self.particles.detach().requires_grad_(True)
        log_prob = meta_log_prob(self.hyper_prior, self.prior_factor, particles, X, Y, M)
        (score,) = torch.autograd.grad(log_prob.sum(), particles)
        with torch.no_grad():
            phi = svgd_phi(self.particles, score, kernel=self.svgd_kernel,
                           bandwidth=self.bandwidth)
            self._apply_update(-phi)
        self._step_count += 1

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def meta_fit(self, valid_tuples=None, verbose=True, log_period=500, n_iter=None):
        """Fits the hyper-posterior particles with SVGD."""
        if valid_tuples is not None and not all(len(t) == 4 for t in valid_tuples):
            raise ValueError("valid tuples must be (ctx_x, ctx_y, test_x, test_y)")
        n_iter = self.num_iter_fit if n_iter is None else n_iter
        want_metrics = verbose or valid_tuples is not None
        t = time.time()
        done = 0
        while done < n_iter:
            chunk = int(min(log_period, n_iter - done))
            for _ in range(chunk):
                self._step()
            done += chunk
            if want_metrics:
                self._sync()
                duration, t = time.time() - t, time.time()
                message = "Iter %d/%d - Time %.2f sec" % (done, n_iter, duration)
                if valid_tuples is not None:
                    valid_ll, valid_rmse, calib = self.eval_datasets(valid_tuples)
                    message += (" - Valid-LL: %.3f - Valid-RMSE: %.3f - Calib-Err %.3f"
                                % (valid_ll, valid_rmse, calib))
                if verbose:
                    self.logger.info(message)
        self.fitted = True

    # --------------------------------------------------------------- predict
    def _predict_moments(self, cx, cy, tx):
        """Per-particle predictive moments in normalised space.

        cx [..., Nc, D], cy [..., Nc], tx [..., Nt, D]
        -> (means [K, ..., Nt], covs [K, ..., Nt, Nt]).
        """
        k = self.num_particles
        params = self.hyper_prior.unravel(self.particles)
        return gp_predict(self.cfg, params, cx.expand(k, *cx.shape), cy,
                          tx.expand(k, *tx.shape))

    @torch.no_grad()
    def _run_batch_eval(self, CX, CY, TX, TY):
        means, covs = self._predict_moments(CX, CY, TX)
        return mixture_eval_metrics(means, covs, TY, float(self.y_mean[0]),
                                    float(self.y_std[0]))

    @torch.no_grad()
    def predict(self, context_x, context_y, test_x, return_density=False):
        """Mixture-over-particles posterior predictive, in original y units."""
        context_x, context_y = handle_input_dim(context_x, context_y)
        test_x = handle_input_dim(test_x)
        if test_x.shape[1] != context_x.shape[1]:
            raise ValueError("test_x and context_x differ in input dimension")
        cx, cy = self._prepare_data_per_task(context_x, context_y)
        tx = self._tensor(self._normalize_x(test_x))
        means, covs = self._predict_moments(cx, cy, tx)
        pred_dist = EqualWeightedMixture(AffineTransformed(
            MultivariateNormal(means, covs), self.y_mean[0], self.y_std[0]))
        if return_density:
            return pred_dist
        return pred_dist.mean.cpu().numpy(), pred_dist.stddev.cpu().numpy()

    # ------------------------------------------------------------ checkpoint
    def state_dict(self):
        return {
            "particles": self.particles.detach().cpu().numpy(),
            "opt_state": {"mu": self._mu.cpu().numpy(), "nu": self._nu.cpu().numpy(),
                          "count": self._adam_count},
            "step": self._step_count,
        }

    def load_state_dict(self, state_dict):
        """Restore a state of this class or a JAX learner's ``state_dict()``."""
        if not isinstance(state_dict["opt_state"], dict):
            state_dict = from_jax_state(state_dict)
        self.particles = self._tensor(state_dict["particles"])
        opt = state_dict["opt_state"]
        self._mu = self._tensor(opt["mu"])
        self._nu = self._tensor(opt["nu"])
        self._adam_count = int(opt["count"])
        self._step_count = int(state_dict.get("step", 0))
