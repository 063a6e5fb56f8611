"""PACOH-SVGD: Stein variational gradient descent on the PAC-optimal hyper-posterior
(counterpart of meta_learning_pacoh_tpu/algos/pacoh_svgd.py).

K particles in GP-prior parameter space. Each step: the score, the gradient
of log(hyper-prior^prior_factor x product of task MLLs); the Stein transport
phi (RBF median heuristic or IMQ); then an Adam or SGD step fed -phi, equal
to ``optax.adam`` / ``optax.sgd`` with the staircase lr schedule
(ops/launch_sched.py).

Two paths, as in the JAX package:

- the fused path: a configuration in the fused window (``_fused_path_ok``:
  NN mean + NN kernel of one hidden width, feature_dim 1, RBF median
  transport, Adam, full batch or a sampled batch of uniform task sizes)
  runs its whole fit through a fused training kernel, one launch per chunk
  and staircase step: tasks of N <= 8 points through
  ops/cuda/fused_svgd_kernel.py (B2), of 9 <= N <= 256 through
  ops/cuda/fused_svgd_bign_kernel.py (B10, by default where the H100's
  faceoff measured it to win, unlike the TPU's policy: ``bign_wins``);
- the general step, one Python loop iteration per step: the score by
  autograd through the batched MLL (the MLL kernels K2/K3 for
  9 <= N <= 48, the blocked MLL kernels B4 for 49 <= N <= 512), the Stein
  kernel K1, and the update here.

A sampled task batch draws the tasks of step s from a generator seeded with
(train seed, s), on both paths, so they follow one random trajectory and do
not depend on how the steps are chunked. ``_stacked_step`` is the general
step of S fits stacked on a leading axis (``parallel.fit_models_parallel``,
``utils.tuning_parallel``), each with its own draws.

``mesh=`` (a ``parallel.make_mesh`` mesh, full batch only) shards the tasks
over the mesh's "task" axis, as the JAX learner's: each rank takes the
score of the particles on its own tasks (the hyper-prior term on the
axis's first rank only), an all_reduce sums the scores, and every rank
applies the same transport (K1) and update to its copy of the particles.
The fused kernels are off under a mesh; the general step runs K1-K3 or B4.
"""

import time

import numpy as np
import torch

from meta_learning_pacoh_torch import config
from meta_learning_pacoh_torch.algos.base import RegressionModelMetaLearned, check_choice
from meta_learning_pacoh_torch.interop import from_jax_state
from meta_learning_pacoh_torch.models.gp_base import gp_predict
from meta_learning_pacoh_torch.models.random_gp import (
    make_hyper_prior,
    meta_log_prob,
    random_gp_config,
)
from meta_learning_pacoh_torch.ops import cuda, launch_sched
from meta_learning_pacoh_torch.ops.cuda.fused_svgd_bign_kernel import (
    FusedSVGDBigNTrainer,
    bign_wins,
    svgd_bign_fits,
)
from meta_learning_pacoh_torch.ops.cuda.fused_svgd_kernel import (
    FusedSVGDTrainer,
    fused_svgd_fits,
)
from meta_learning_pacoh_torch.ops.distributions import (
    AffineTransformed,
    EqualWeightedMixture,
    MultivariateNormal,
    Normal,
)
from meta_learning_pacoh_torch.ops.metrics import mixture_eval_metrics
from meta_learning_pacoh_torch.ops.svgd import svgd_phi
from meta_learning_pacoh_torch.utils.input_handling import handle_input_dim
from meta_learning_pacoh_torch.utils.profiling import (
    LEARNER_GATE,
    LEARNER_INIT,
    LEARNER_META_FIT,
    LEARNER_STEP,
    OPS_SCORE,
    OPS_TRANSPORT,
    OPS_UPDATE,
    span,
    spanned,
)


class GPRegressionMetaLearnedSVGD(RegressionModelMetaLearned):

    @spanned(LEARNER_INIT)
    def __init__(self, meta_train_data, num_iter_fit=10000, feature_dim=1,
                 prior_factor=0.01, weight_prior_std=0.5, bias_prior_std=3.0,
                 covar_module="NN", mean_module="NN", mean_nn_layers=(32, 32),
                 kernel_nn_layers=(32, 32), optimizer="Adam", lr=1e-3, lr_decay=1.0,
                 kernel="RBF", bandwidth=None, num_particles=10, task_batch_size=-1,
                 normalize_data=True, random_seed=None, mesh=None, device=None):
        """mesh: a ``parallel.make_mesh`` mesh with a "task" axis, of the
        learner's device type; requires task_batch_size=-1 (full batch).
        device: where the particles, the data and the computation live
        ('cuda', 'cpu', a torch.device); None means the card, and raises
        without one."""
        super().__init__(normalize_data, random_seed, device)
        check_choice("mean_module", mean_module, ("NN", "constant"))
        check_choice("covar_module", covar_module, ("NN", "SE"))
        check_choice("optimizer", optimizer, ("Adam", "SGD"))
        check_choice("kernel", kernel, ("RBF", "IMQ"))

        self.num_iter_fit = num_iter_fit
        self.prior_factor = prior_factor
        self.num_particles = num_particles
        self.svgd_kernel, self.bandwidth = kernel, bandwidth
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
        self.particles = self.hyper_prior.sample(self._generator, (num_particles,))
        # task draws of step s come from a generator seeded with (train seed, s),
        # so they do not depend on how the steps are chunked
        self._train_seed = int(torch.randint(0, 2 ** 31, (1,), generator=self._generator))
        self._mu = torch.zeros_like(self.particles)
        self._nu = torch.zeros_like(self.particles)
        self._adam_count = 0
        self._step_count = 0
        self._fused = None  # the fused kernel's FusedSVGDTrainer, built at the first fused fit

    # ------------------------------------------------------------ train step
    def _task_draw(self, step):
        """Task indices (a CPU tensor) of the sampled batch of global step ``step``."""
        seed = int(np.random.SeedSequence([self._train_seed, step]).generate_state(1)[0])
        gen = torch.Generator().manual_seed(seed)
        return torch.randint(0, self.n_tasks, (self.task_batch_size,), generator=gen)

    def _task_batch(self):
        if self.task_batch_size == self.n_tasks:
            return self.X, self.Y, self.mask
        idx = self._task_draw(self._step_count).to(self.device)
        return self.X[idx], self.Y[idx], self.mask[idx]

    def _update(self, particles, mu, nu, grad, lr, adam_count):
        """One optax-equivalent Adam (at step ``adam_count``) or SGD step on
        particles [..., K, P], in place; lr a number or per fit [S, 1, 1]."""
        if self._optimizer_name == "SGD":
            particles.sub_(lr * grad)
        else:
            cuda.adam_step_(particles, mu, nu, grad, adam_count, lr)

    def _apply_update(self, grad):
        """One optax-equivalent Adam or SGD step on the particles, in place."""
        lr = launch_sched.staircase_lr(self._lr, self._lr_decay, self._step_count)
        if self._optimizer_name == "Adam":
            self._adam_count += 1
        self._update(self.particles, self._mu, self._nu, grad, lr, self._adam_count)

    def _transport(self, particles, data, prior_factor, bandwidth):
        """-phi, the update direction of particles [..., K, P] on the task
        batch ``data`` (X, Y, mask): the score by autograd, then the Stein
        transport (one K1 launch for all fits of a stack)."""
        with span(OPS_SCORE):
            part = particles.detach().requires_grad_(True)
            log_prob = meta_log_prob(self.hyper_prior, prior_factor, part, *data,
                                     **self._shard_terms())
            (score,) = torch.autograd.grad(log_prob.sum(), part)
            if self._shard is not None:
                self._shard.all_reduce_(score)
        with span(OPS_TRANSPORT), torch.no_grad():
            return -svgd_phi(particles, score, kernel=self.svgd_kernel, bandwidth=bandwidth)

    @spanned(LEARNER_STEP)
    def _step(self):
        grad = self._transport(self.particles, self._task_batch(), self.prior_factor,
                               self.bandwidth)
        with span(OPS_UPDATE), torch.no_grad():
            self._apply_update(grad)
        self._step_count += 1

    def _stacked_step(self, stack):
        """One general step of S stacked fits (``parallel.seed_parallel.SeedStack``:
        particles [S, K, P], each fit with its own data, task draws,
        prior_factor, bandwidth and lr), in place."""
        data = stack.data
        if self.task_batch_size != self.n_tasks:
            data = stack.gather(data, [m._task_draw(stack.step) for m in stack.models])
        bandwidth = None if self.bandwidth is None else stack.per_seed("bandwidth")
        particles = stack.state["particles"]
        grad = self._transport(particles, data, stack.per_seed("prior_factor"), bandwidth)
        if self._optimizer_name == "Adam":
            stack.adam_count += 1
        with torch.no_grad():
            self._update(particles, stack.state["_mu"], stack.state["_nu"], grad,
                         stack.staircase("_lr")[:, None, None], stack.adam_count)
        stack.step += 1

    # ------------------------------------------------------------ fused path
    @spanned(LEARNER_GATE)
    def _fused_path_ok(self):
        """Whether a fused training kernel carries the fit: the JAX learner's
        gate (pacoh_svgd.py:237-251), with its N <= 8 arm (B2) and its
        9 <= N <= 256 arm (B10, where the H100's faceoff measured it to win:
        ``bign_wins``, the counterpart of the JAX learner's
        ``svgd_bign_wins``), and a configuration the kernel takes."""
        cfg = self.cfg
        hidden = tuple(cfg.mean_nn_layers)
        sizes = torch.sum(self.mask, dim=-1)
        t, n, d = self.X.shape
        return (
            config.fused_enabled()
            and self._mesh is None
            # full batch, or sampled batches as count pages of uniform task sizes
            and (self.task_batch_size == self.n_tasks or bool(torch.all(sizes == sizes[0])))
            and self.svgd_kernel == "RBF" and self.bandwidth is None
            and self._optimizer_name == "Adam"
            and cfg.mean_module == "NN" and cfg.covar_module == "NN"
            and cfg.feature_dim == 1
            and hidden == tuple(cfg.kernel_nn_layers)
            and len(set(hidden)) == 1 and len(hidden) >= 1
            and self.num_particles * hidden[0] <= 1024
            and (fused_svgd_fits(self.num_particles, t, n, d, hidden) if n <= 8
                 else (svgd_bign_fits(self.num_particles, t, n, d, hidden)
                       and bign_wins(self.num_particles * t)))
        )

    def _fused_run_chunk(self, chunk):
        """``chunk`` steps through the fused kernel, from the live particles and
        Adam moments (so a fit may resume after general steps), one launch per
        staircase step; the counts advance launch by launch."""
        if self._fused is None:
            trainer_cls = FusedSVGDTrainer if self.X.shape[1] <= 8 else FusedSVGDBigNTrainer
            self._fused = trainer_cls(
                self.X, self.Y, self.mask, hidden=tuple(self.cfg.mean_nn_layers),
                lr=self._lr, lr_decay=self._lr_decay, prior_factor=self.prior_factor,
                weight_prior_std=self._weight_prior_std,
                bias_prior_std=self._bias_prior_std,
                task_batch_size=self.task_batch_size, task_draw=self._task_draw)
        for step0, sub in self._fused.launches(self._step_count, chunk):
            self._fused.launch(self.particles, self._mu, self._nu, step0, sub)
            self._step_count += sub
            self._adam_count += sub

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @spanned(LEARNER_META_FIT)
    def meta_fit(self, valid_tuples=None, verbose=True, log_period=500, n_iter=None):
        """Fits the hyper-posterior particles with SVGD."""
        if valid_tuples is not None and not all(len(t) == 4 for t in valid_tuples):
            raise ValueError("valid tuples must be (ctx_x, ctx_y, test_x, test_y)")
        n_iter = self.num_iter_fit if n_iter is None else n_iter
        want_metrics = verbose or valid_tuples is not None
        use_fused = self._fused_path_ok()
        t = time.time()
        done = 0
        while done < n_iter:
            chunk = int(min(log_period, n_iter - done))
            if use_fused:
                self._fused_run_chunk(chunk)
            else:
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

    def _vectorize_pred_dist(self, pred_dist):
        """The mixture of per-point Normals of the particles' predictives."""
        base = pred_dist.base
        return EqualWeightedMixture(Normal(base.mean, base.stddev))

    # ------------------------------------------------------------ checkpoint
    def state_dict(self):
        # copies: the fit updates the particles and moments in place
        return {
            "particles": self.particles.detach().cpu().numpy().copy(),
            "opt_state": {"mu": self._mu.cpu().numpy().copy(),
                          "nu": self._nu.cpu().numpy().copy(), "count": self._adam_count},
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
