"""PACOH-MAP: meta-learning one GP prior by AdamW on the summed task MLLs
(counterpart of meta_learning_pacoh_tpu/algos/pacoh_map.py).

A shared NN mean, NN-featurised RBF kernel (with an outputscale) and noise,
trained on the loss -sum_t MLL_t / n_t over a task batch by AdamW (the
weight decay is the meta-regulariser) or SGD, with the staircase lr
schedule of ops/launch_sched.py; ``learning_mode`` freezes parameter groups,
and a frozen leaf gets neither an update nor weight decay (optax's
``set_to_zero``). Meta-test prediction conditions the GP on the context set.

The parameters, and the AdamW moments, are one flat float32 vector [P] in
the JAX package's ``ravel_pytree`` order (``flat_layout``); ``gp_base``
sees them with a particle axis of 1.

Two paths, as in the JAX package:

- the fused path: a configuration in the fused window (``_fused_path_ok``:
  NN mean + NN kernel, ``learning_mode="both"``, Adam, feature_dim <= 8,
  and the kernel's own fit test) runs its whole fit through a fused
  training kernel, one launch per chunk and staircase step (at most 512
  steps a launch for a sampled batch): tasks of N <= 8 points through
  ops/cuda/fused_map_kernel.py (B6), of 9 <= N <= 512 through
  ops/cuda/fused_map_bign_kernel.py (B9);
- the general step, one Python loop iteration per step: the loss by
  ``gp_prior_mll_batch`` (whose MLL takes the MLL kernels K2/K3 for
  9 <= N <= 48 and the blocked ones, B4, for 49 <= N <= 512), its gradient
  by autograd, and the update here.

A sampled task batch draws the tasks of step s from a generator seeded with
(train seed, s), on both paths, and weights every task's MLL by its draw
count (the JAX learner's count-weighted mode, ``PACOH_TPU_MAP_WEIGHTED=1``:
the same estimator as gathering the drawn tasks), which lets the fused
kernels carry the fit. ``_stacked_step`` is the general step of S fits
stacked on a leading axis (``parallel.fit_models_parallel``,
``utils.tuning_parallel``), each with its own draws.

``mesh=`` (a ``parallel.make_mesh`` mesh, full batch only) runs the
general step on every rank of the mesh, as the JAX learner's: tasks of up
to BLOCKED_MAX_N points are sharded over the "task" axis (each rank's
share of the loss, the gradient summed by an all_reduce); above it the
tasks stay whole on every rank and each Gram matrix is factored across the
ranks by the distributed tier (``ops.gp.distributed_linalg``), whose
closed-form backward already gives the whole gradient. The fused kernels
are off under a mesh.
"""

import time

import numpy as np
import torch

from meta_learning_pacoh_torch import config
from meta_learning_pacoh_torch.algos.base import (
    RegressionModelMetaLearned,
    check_choice,
    tier_ctx,
    tier_mesh,
)
from meta_learning_pacoh_torch.interop import from_jax_map_state
from meta_learning_pacoh_torch.models.gp_base import (
    GPConfig,
    gp_predict,
    gp_prior_mll_batch,
    init_gp_params,
)
from meta_learning_pacoh_torch.models.modules import KernelModule, MeanModule
from meta_learning_pacoh_torch.models.random_gp import flat_layout, ravel_flat, unravel_flat
from meta_learning_pacoh_torch.ops import cuda, launch_sched
from meta_learning_pacoh_torch.ops.cuda.fused_map_bign_kernel import (
    FusedMAPBigNTrainer,
    bign_fits,
)
from meta_learning_pacoh_torch.ops.cuda.fused_map_kernel import (
    MAX_N as FUSED_MAX_N,
    FusedMAPTrainer,
    fused_map_fits,
)
from meta_learning_pacoh_torch.ops.distributions import (
    AffineTransformed,
    MultivariateNormal,
    Normal,
)
from meta_learning_pacoh_torch.ops.metrics import gp_eval_metrics
from meta_learning_pacoh_torch.utils.input_handling import handle_input_dim


def make_lr_schedule(lr, lr_decay):
    """The JAX module's schedule: ``lr`` itself when ``lr_decay`` >= 1, else a
    function of the 0-based step giving the staircase lr, ``lr`` times
    ``lr_decay`` once every ``LR_TRANSITION_STEPS`` steps (the value at its
    making), as ``optax.exponential_decay(..., staircase=True)``. The
    learners read ``launch_sched.staircase_lr`` themselves."""
    if lr_decay < 1.0:
        transition = launch_sched.LR_TRANSITION_STEPS
        return lambda step: launch_sched.staircase_lr(lr, lr_decay, step, transition)
    return lr


def _trains(leaf, learning_mode):
    """Whether a top-level parameter leaf trains under ``learning_mode``
    (the likelihood noise always does; a custom kernel's leaves train with
    the kernel, a custom mean's with the mean)."""
    if leaf == "noise_raw":
        return True
    if leaf in ("lengthscale_raw", "outputscale_raw", "kernel_nn", "custom_kernel"):
        return learning_mode in ("learn_kernel", "both")
    return learning_mode in ("learn_mean", "both")  # mean_nn, constant_mean, custom_mean


class GPRegressionMetaLearned(RegressionModelMetaLearned):

    def __init__(self, meta_train_data, learning_mode="both", lr_params=1e-3,
                 weight_decay=0.0, feature_dim=2, num_iter_fit=10000,
                 covar_module="NN", mean_module="NN", mean_nn_layers=(32, 32),
                 kernel_nn_layers=(32, 32), task_batch_size=5, normalize_data=True,
                 optimizer="Adam", lr_decay=1.0, random_seed=None, mesh=None, device=None):
        """mesh: a ``parallel.make_mesh`` mesh with a "task" axis, of the
        learner's device type; requires task_batch_size=-1 (full batch).
        device: where the parameters, the data and the computation live
        ('cuda', 'cpu', a torch.device); None means the card, and raises
        without one."""
        super().__init__(normalize_data, random_seed, device)
        check_choice("learning_mode", learning_mode,
                      ("learn_mean", "learn_kernel", "both", "vanilla"))
        if not isinstance(mean_module, MeanModule):
            check_choice("mean_module", mean_module, ("NN", "constant", "zero"))
        if not isinstance(covar_module, KernelModule):
            check_choice("covar_module", covar_module, ("NN", "SE"))
        check_choice("optimizer", optimizer, ("Adam", "SGD"))
        if covar_module == "NN" and learning_mode not in ("learn_kernel", "both"):
            raise ValueError("a kernel NN must be learned")
        if mean_module == "NN" and learning_mode not in ("learn_mean", "both"):
            raise ValueError("a mean NN must be learned")

        self.lr_params, self.weight_decay = lr_params, weight_decay
        self.num_iter_fit = num_iter_fit
        self.learning_mode = learning_mode
        self._optimizer_name, self._lr_decay = optimizer, lr_decay

        self._check_and_set_dims(meta_train_data)
        self._compute_normalization_stats(meta_train_data)
        self.X, self.Y, self.mask = self._prepare_meta_data(meta_train_data)
        self.n_tasks = self.X.shape[0]
        self.task_batch_size = self.n_tasks if task_batch_size < 0 else task_batch_size
        # large N: every rank holds every task, and the ranks factor each
        # Gram matrix together (block rows over the task axis)
        self._dist_linalg = tier_mesh(mesh, self.X.shape[1])
        self._shard_tasks(mesh, self.task_batch_size == self.n_tasks,
                          replicate=self._dist_linalg is not None)

        self.cfg = GPConfig(input_dim=self.input_dim, feature_dim=feature_dim,
                            mean_module=mean_module, covar_module=covar_module,
                            mean_nn_layers=tuple(mean_nn_layers),
                            kernel_nn_layers=tuple(kernel_nn_layers))
        self.layout = flat_layout(self.cfg)
        self.params = ravel_flat(self.layout, init_gp_params(self.cfg, self._generator)).to(
            self.device)
        # task draws of step s come from a generator seeded with (train seed, s),
        # so they do not depend on how the steps are chunked
        self._train_seed = int(torch.randint(0, 2 ** 31, (1,), generator=self._generator))
        self._train_mask = torch.cat([
            torch.full((size,), float(_trains(path[0], learning_mode)))
            for path, _, _, size in self.layout]).to(self.device)
        self._mu = torch.zeros_like(self.params)
        self._nu = torch.zeros_like(self.params)
        self._adam_count = 0
        self._step_count = 0
        self._fused = None  # the fused kernel's trainer, built at the first fused fit

    # ------------------------------------------------------------ train step
    def _task_draw(self, step):
        """Task indices (a CPU tensor) of the sampled batch of global step ``step``."""
        seed = int(np.random.SeedSequence([self._train_seed, step]).generate_state(1)[0])
        gen = torch.Generator().manual_seed(seed)
        return torch.randint(0, self.n_tasks, (self.task_batch_size,), generator=gen)

    def _counts(self, step):
        """[T] draw counts of global step ``step``'s sampled batch (on the
        device), None for the full batch."""
        if self.task_batch_size == self.n_tasks:
            return None
        idx = self._task_draw(step)
        return torch.bincount(idx, minlength=self.n_tasks).float().to(self.device)

    def _loss(self, params, data, counts):
        """-sum of the step's per-task MLL / n at flat ``params`` [P] on the
        tasks ``data`` (X, Y, mask); counts [T] (None: the full batch)
        weights each task's MLL by its draw count. Stacked: params [S, P],
        data and counts per fit -> [S]."""
        lls = gp_prior_mll_batch(self.cfg, unravel_flat(self.layout, params[..., None, :]),
                                 *data)[..., 0, :]
        if counts is not None:
            # a never-drawn task's MLL (maybe NaN) is replaced, not multiplied by 0
            lls = torch.where(counts > 0, counts * torch.where(counts > 0, lls, 0.0), 0.0)
        return -torch.sum(lls, dim=-1)

    def _update(self, params, mu, nu, grad, lr, weight_decay, adam_count):
        """One optax-equivalent AdamW (at step ``adam_count``) or SGD step on
        the trained leaves of params [..., P], in place; lr and weight_decay
        numbers or per fit [S, 1]."""
        if self._optimizer_name == "SGD":
            params.sub_(lr * self._train_mask * grad)
        else:
            cuda.adam_step_(params, mu, nu, grad, adam_count, lr, weight_decay,
                            mask=self._train_mask)

    def _apply_update(self, grad):
        """One optax-equivalent AdamW or SGD step on the trained leaves, in place."""
        lr = launch_sched.staircase_lr(self.lr_params, self._lr_decay, self._step_count)
        if self._optimizer_name == "Adam":
            self._adam_count += 1
        self._update(self.params, self._mu, self._nu, grad, lr, self.weight_decay,
                     self._adam_count)

    def _grad(self, params, data, counts):
        """(loss, its gradient) at params [..., P], the loss summed over the fits."""
        params = params.detach().requires_grad_(True)
        loss = self._loss(params, data, counts)
        (grad,) = torch.autograd.grad(loss.sum(), params)
        return loss.detach(), grad

    def _step(self):
        """One general step; returns its loss (a device scalar)."""
        with tier_ctx(self._dist_linalg):
            loss, grad = self._grad(self.params, (self.X, self.Y, self.mask),
                                    self._counts(self._step_count))
        if self._shard is not None:
            self._shard.all_reduce_(loss, grad)
        with torch.no_grad():
            self._apply_update(grad)
        self._step_count += 1
        return loss

    def _stacked_step(self, stack):
        """One general step of S stacked fits (``parallel.seed_parallel.SeedStack``:
        params [S, P], each fit with its own data, task draws, lr and weight
        decay), in place; returns the losses [S]."""
        counts = None
        if self.task_batch_size != self.n_tasks:
            counts = torch.stack([m._counts(stack.step) for m in stack.models])
        params = stack.state["params"]
        loss, grad = self._grad(params, stack.data, counts)
        if self._optimizer_name == "Adam":
            stack.adam_count += 1
        with torch.no_grad():
            self._update(params, stack.state["_mu"], stack.state["_nu"], grad,
                         stack.staircase("lr_params")[:, None],
                         stack.per_seed("weight_decay")[:, None], stack.adam_count)
        stack.step += 1
        return loss

    # ------------------------------------------------------------ fused path
    def _fused_path_ok(self):
        """Whether a fused training kernel carries the fit: the JAX learner's
        gate, its N <= 8 arm (B6) and its 9 <= N <= 512 arm (B9), with each
        kernel's own fit test in place of the TPU's VMEM tests."""
        cfg = self.cfg
        t, n, d = self.X.shape
        fits = fused_map_fits if n <= FUSED_MAX_N else bign_fits
        return (
            config.fused_enabled()
            and self._mesh is None
            and self.learning_mode == "both"
            and self._optimizer_name == "Adam"
            and cfg.mean_module == "NN" and cfg.covar_module == "NN"
            and fits(t, n, d, cfg.feature_dim, cfg.mean_nn_layers, cfg.kernel_nn_layers)
        )

    def _fused_trainer(self):
        """A new trainer of the fused kernel for this learner's tasks: B6's
        for N <= 8, B9's above."""
        trainer = FusedMAPTrainer if self.X.shape[1] <= FUSED_MAX_N else FusedMAPBigNTrainer
        return trainer(self.X, self.Y, self.mask, layout=self.layout, lr=self.lr_params,
                       weight_decay=self.weight_decay, lr_decay=self._lr_decay,
                       task_batch_size=self.task_batch_size, task_draw=self._task_draw)

    def _fused_run_chunk(self, chunk):
        """``chunk`` steps through the fused kernel, from the live parameters
        and AdamW moments (so a fit may resume after general steps).
        Returns (last loss, mean loss) as device scalars."""
        if self._fused is None:
            self._fused = self._fused_trainer()
        losses = self._fused.run(self.params, self._mu, self._nu, chunk, self._step_count)
        self._step_count += chunk
        self._adam_count += chunk
        return losses

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def meta_fit(self, valid_tuples=None, verbose=True, log_period=500, n_iter=None):
        """Meta-learns the GP prior's parameters. Returns the last step's loss."""
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
                last, mean = self._fused_run_chunk(chunk)
            else:
                losses = torch.stack([self._step() for _ in range(chunk)])
                last, mean = losses[-1], torch.mean(losses)
            done += chunk
            if want_metrics:
                self._sync()
                duration, t = time.time() - t, time.time()
                message = "Iter %d/%d - Loss: %.6f - Time %.2f sec" % (
                    done, n_iter, float(mean), duration)
                if valid_tuples is not None:
                    valid_ll, valid_rmse, calib = self.eval_datasets(valid_tuples)
                    message += (" - Valid-LL: %.3f - Valid-RMSE: %.3f - Calib-Err %.3f"
                                % (valid_ll, valid_rmse, calib))
                if verbose:
                    self.logger.info(message)
        self.fitted = True
        return float("nan") if last is None else float(last)

    # --------------------------------------------------------------- predict
    def _predict_moments(self, cx, cy, tx):
        """GP predictive moments in normalised space: cx [..., Nc, D],
        cy [..., Nc], tx [..., Nt, D] -> (mean [..., Nt], cov [..., Nt, Nt])."""
        params = unravel_flat(self.layout, self.params[None])
        mean, cov = gp_predict(self.cfg, params, cx[None], cy, tx[None])
        return mean[0], cov[0]

    @torch.no_grad()
    def _run_batch_eval(self, CX, CY, TX, TY):
        mean, cov = self._predict_moments(CX, CY, TX)
        return gp_eval_metrics(mean, cov, TY, float(self.y_mean[0]), float(self.y_std[0]))

    @torch.no_grad()
    def predict(self, context_x, context_y, test_x, return_density=False):
        """Posterior predictive p(y* | x*, context), in original y units."""
        context_x, context_y = handle_input_dim(context_x, context_y)
        test_x = handle_input_dim(test_x)
        if test_x.shape[1] != context_x.shape[1]:
            raise ValueError("test_x and context_x differ in input dimension")
        cx, cy = self._prepare_data_per_task(context_x, context_y)
        tx = self._tensor(self._normalize_x(test_x))
        mean, cov = self._predict_moments(cx, cy, tx)
        pred_dist = AffineTransformed(MultivariateNormal(mean, cov), self.y_mean[0],
                                      self.y_std[0])
        if return_density:
            return pred_dist
        return pred_dist.mean.cpu().numpy(), pred_dist.stddev.cpu().numpy()

    def _vectorize_pred_dist(self, pred_dist):
        return Normal(pred_dist.mean, pred_dist.stddev)

    # ------------------------------------------------------------ checkpoint
    def state_dict(self):
        # copies: the fit updates the parameters and moments in place
        return {
            "params": self.params.detach().cpu().numpy().copy(),
            "opt_state": {"mu": self._mu.cpu().numpy().copy(),
                          "nu": self._nu.cpu().numpy().copy(), "count": self._adam_count},
            "step": self._step_count,
        }

    def load_state_dict(self, state_dict):
        """Restore a state of this class or a JAX learner's ``state_dict()``."""
        if isinstance(state_dict["params"], dict):
            state_dict = from_jax_map_state(state_dict)
        self.params = self._tensor(state_dict["params"])
        opt = state_dict["opt_state"]
        self._mu = self._tensor(opt["mu"])
        self._nu = self._tensor(opt["nu"])
        self._adam_count = int(opt["count"])
        self._step_count = int(state_dict.get("step", 0))
