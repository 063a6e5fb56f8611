"""Single-task GP regression with a learned NN mean and NN-featurised kernel
(counterpart of meta_learning_pacoh_tpu/algos/gpr_mll.py).

The GP prior's mean, kernel and noise are fit by maximising the exact MLL of
the training set, the same set the posterior then conditions on. AdamW (or
SGD) with the JAX learner's optimizer groups: the NN leaves decay by
``weight_decay``, the hyperparameters (noise, lengthscale, outputscale,
constant mean, a custom module's leaves) by 0.01, torch AdamW's default
(0 under SGD); ``learning_mode`` freezes leaves, and a frozen leaf gets
neither an update nor decay. With a validation set, a plateau scheduler
scales the lr of both groups after every ``log_period`` chunk.

The parameters and the Adam moments are one flat float32 vector [P] in the
JAX package's ``ravel_pytree`` order; ``gp_base`` sees them with a particle
axis of 1. A step is the loss under autograd and ``ops/cuda.adam_step_``,
one Python iteration: the MLL of one system (``gp_prior_mll``, B = 1) takes
the MLL kernels K2/K3 for 9 <= N <= 48 and the blocked ones (B4) for
49 <= N <= 512; ``predict`` and ``eval`` factor through ``ops/chol.py``
(B5 for 32-64 points, K4 for 65-512). GPR-MLL's ``mesh=`` (as the JAX
learner's) routes the training MLL of more than BLOCKED_MAX_N points
through the distributed tier (``ops.gp.distributed_linalg``: the Gram
matrix factored across the ranks of the mesh's "task" axis, every rank
holding the task whole); a smaller task ignores the mesh.
"""

import time

import torch

from meta_learning_pacoh_torch.algos.base import RegressionModel, check_choice, tier_ctx, tier_mesh
from meta_learning_pacoh_torch.interop import from_jax_gpr_state
from meta_learning_pacoh_torch.models.gp_base import (
    GPConfig,
    gp_predict,
    gp_prior_mll,
    init_gp_params,
)
from meta_learning_pacoh_torch.models.modules import KernelModule, MeanModule
from meta_learning_pacoh_torch.models.random_gp import flat_layout, ravel_flat, unravel_flat
from meta_learning_pacoh_torch.ops import cuda
from meta_learning_pacoh_torch.ops.distributions import (
    AffineTransformed,
    MultivariateNormal,
    Normal,
)
from meta_learning_pacoh_torch.parallel import mesh as mesh_ops
from meta_learning_pacoh_torch.utils.input_handling import handle_input_dim

HYPER_WEIGHT_DECAY = 0.01  # torch AdamW's default, which the hyperparameter groups keep


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau in mode 'max' on the host:
    scale the lr by ``factor`` after ``patience`` steps without improvement."""

    def __init__(self, factor=0.2, patience=10, threshold=1e-4):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.best = -float("inf")
        self.num_bad = 0
        self.scale = 1.0

    def step(self, metric):
        # torch's is_better in mode 'max', threshold_mode 'rel'
        if metric > self.best * (1.0 + self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.scale *= self.factor
            self.num_bad = 0
        return self.scale


def param_group(name, learning_mode):
    """The optimizer group of a top-level GP leaf: 'nn', 'hyper' or 'freeze'
    (the JAX learners' ``_param_labels``; the noise always trains)."""
    learn_kernel = learning_mode in ("learn_kernel", "both")
    learn_mean = learning_mode in ("learn_mean", "both")
    if name == "noise_raw":
        return "hyper"
    if name in ("lengthscale_raw", "outputscale_raw", "custom_kernel"):
        return "hyper" if learn_kernel else "freeze"
    if name in ("constant_mean", "custom_mean"):
        return "hyper" if learn_mean else "freeze"
    if name == "kernel_nn":
        return "nn" if learn_kernel else "freeze"
    if name == "mean_nn":
        return "nn" if learn_mean else "freeze"
    return "freeze"


class SingleTaskLearner(RegressionModel):
    """What the single-task learners share: the data, the flat parameters
    with the grouped AdamW or SGD, the chunked fit with the plateau
    scheduler, the predictive's un-normalisation and the checkpoint. A
    subclass sets ``layout`` and ``params``, then calls ``_setup_optimizer``
    with the group of each layout entry, and defines ``_loss`` and
    ``_predict_moments``."""

    def __init__(self, train_x, train_t, learning_mode, lr, weight_decay, num_iter_fit,
                 optimizer, normalize_data, lr_scheduler, random_seed, device):
        super().__init__(normalize_data=normalize_data, random_seed=random_seed, device=device)
        check_choice("learning_mode", learning_mode,
                     ("learn_mean", "learn_kernel", "both", "vanilla"))
        check_choice("optimizer", optimizer, ("Adam", "SGD"))
        self.lr, self.weight_decay, self.num_iter_fit = lr, weight_decay, num_iter_fit
        self.learning_mode = learning_mode
        self._optimizer_name = optimizer
        train_x, train_t = handle_input_dim(train_x, train_t)
        self.input_dim, self.output_dim = train_x.shape[-1], train_t.shape[-1]
        self.n_train_samples = train_x.shape[0]
        self._set_normalization_stats(train_x, train_t)
        self.train_x, self.train_t = self._prepare_data_per_task(train_x, train_t)
        self._plateau = ReduceLROnPlateau(factor=0.2 if lr_scheduler else 1.0)
        self._step_count = 0

    def _setup_optimizer(self, groups):
        """Per-coordinate train mask and decay vectors from ``groups``, the
        optimizer group of each layout entry, and a fresh Adam state."""
        hyper_decay = HYPER_WEIGHT_DECAY if self._optimizer_name == "Adam" else 0.0
        decay = {"nn": self.weight_decay, "hyper": hyper_decay, "freeze": 0.0}
        sizes = [size for _, _, _, size in self.layout]
        self._train_mask = torch.cat([torch.full((s,), float(g != "freeze"))
                                      for g, s in zip(groups, sizes)]).to(self.device)
        self._decay = torch.cat([torch.full((s,), decay[g])
                                 for g, s in zip(groups, sizes)]).to(self.device)
        self._mu = torch.zeros_like(self.params)
        self._nu = torch.zeros_like(self.params)
        self._adam_count = 0
        self._lr_now = self.lr

    # ------------------------------------------------------------ train step
    def _loss(self, params):
        """The training loss at flat ``params`` [P] (a device scalar)."""
        raise NotImplementedError

    def _step(self):
        """One step; returns its loss (a device scalar)."""
        params = self.params.detach().requires_grad_(True)
        loss = self._loss(params)
        (grad,) = torch.autograd.grad(loss, params)
        with torch.no_grad():
            if self._optimizer_name == "SGD":
                self.params.sub_(self._lr_now * self._train_mask
                                 * (grad + self._decay * self.params))
            else:
                self._adam_count += 1
                cuda.adam_step_(self.params, self._mu, self._nu, grad, self._adam_count,
                                self._lr_now, self._decay, mask=self._train_mask)
        self._step_count += 1
        return loss.detach()

    def _fit_message(self):
        """What a subclass adds to a chunk's log line."""
        return ""

    def fit(self, valid_x=None, valid_t=None, verbose=True, log_period=500, n_iter=None):
        """Fits the GP prior's parameters; with a validation set, the plateau
        scheduler scales the lr after every chunk of ``log_period`` steps.
        Returns the last step's loss."""
        n_iter = self.num_iter_fit if n_iter is None else n_iter
        t = time.time()
        loss = float("nan")
        done = 0
        while done < n_iter:
            chunk = int(min(log_period, n_iter - done))
            for _ in range(chunk):
                last = self._step()
            done += chunk
            loss = float(last)
            duration, t = time.time() - t, time.time()
            message = "Iter %d/%d - Loss: %.3f%s - Time %.3f sec" % (
                done, n_iter, loss, self._fit_message(), duration)
            if valid_x is not None:
                valid_ll, valid_rmse, calib = self.eval(valid_x, valid_t)
                self._lr_now = self.lr * self._plateau.step(valid_ll)
                message += " - Valid-LL: %.3f - Valid-RMSE: %.3f - Calib-Err %.3f" % (
                    valid_ll, valid_rmse, calib)
            if verbose:
                self.logger.info(message)
        self.fitted = True
        return loss

    # --------------------------------------------------------------- predict
    def _predict_moments(self, test_xn):
        """Predictive (mean [Nt], cov [Nt, Nt]) in normalised space, the
        observation noise included."""
        raise NotImplementedError

    @torch.no_grad()
    def predict(self, test_x, return_density=False):
        """Predictive p(y* | x*, train data), in original y units."""
        test_x = handle_input_dim(test_x)
        mean, cov = self._predict_moments(self._tensor(self._normalize_x(test_x)))
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
                          "nu": self._nu.cpu().numpy().copy(), "count": self._adam_count,
                          "lr": self._lr_now},
            "step": self._step_count,
        }

    def load_state_dict(self, state_dict):
        """Restore a state of this class or a JAX learner's ``state_dict()``."""
        if isinstance(state_dict["params"], dict):
            state_dict = from_jax_gpr_state(state_dict)
        self.params = self._tensor(state_dict["params"])
        opt = state_dict["opt_state"]
        self._mu = self._tensor(opt["mu"])
        self._nu = self._tensor(opt["nu"])
        self._adam_count = int(opt["count"])
        self._lr_now = float(opt["lr"])
        self._step_count = int(state_dict.get("step", 0))


class GPRegressionLearned(SingleTaskLearner):

    def __init__(self, train_x, train_t, learning_mode="both", lr=1e-3, weight_decay=0.0,
                 feature_dim=2, num_iter_fit=1000, covar_module="NN", mean_module="NN",
                 mean_nn_layers=(32, 32), kernel_nn_layers=(32, 32), optimizer="Adam",
                 normalize_data=True, lr_scheduler=True, random_seed=None, mesh=None,
                 device=None):
        """mesh: a ``parallel.make_mesh`` mesh of the learner's device type;
        with a "task" axis and more than BLOCKED_MAX_N training points, the
        training MLL's factorization is spread over it. device: where the
        parameters, the data and the computation live ('cuda', 'cpu', a
        torch.device); None means the card, and raises without one.
        ``mean_module`` / ``covar_module`` take a ``MeanModule`` /
        ``KernelModule`` instance too."""
        super().__init__(train_x, train_t, learning_mode, lr, weight_decay, num_iter_fit,
                         optimizer, normalize_data, lr_scheduler, random_seed, device)
        if not isinstance(mean_module, MeanModule):
            check_choice("mean_module", mean_module, ("NN", "constant", "zero"))
        if not isinstance(covar_module, KernelModule):
            check_choice("covar_module", covar_module, ("NN", "SE"))
        if covar_module == "NN" and learning_mode not in ("learn_kernel", "both"):
            raise ValueError("a kernel NN must be learned")
        if mean_module == "NN" and learning_mode not in ("learn_mean", "both"):
            raise ValueError("a mean NN must be learned")

        self.cfg = GPConfig(input_dim=self.input_dim, feature_dim=feature_dim,
                            mean_module=mean_module, covar_module=covar_module,
                            mean_nn_layers=tuple(mean_nn_layers),
                            kernel_nn_layers=tuple(kernel_nn_layers),
                            # the likelihood's noise floor (gpytorch's GreaterThan(1e-4))
                            has_outputscale=True, noise_floor=1e-4)
        self.layout = flat_layout(self.cfg)
        self.params = ravel_flat(self.layout, init_gp_params(self.cfg, self._generator)).to(
            self.device)
        self._setup_optimizer([param_group(path[0], learning_mode)
                               for path, _, _, _ in self.layout])
        if mesh is not None:
            mesh_ops.check_mesh_device(mesh, self.device)
        self._dist_linalg = tier_mesh(mesh, self.n_train_samples)

    def _gp_params(self, params):
        return unravel_flat(self.layout, params[None])

    def _loss(self, params):
        with tier_ctx(self._dist_linalg):
            return -gp_prior_mll(self.cfg, self._gp_params(params), self.train_x,
                                 self.train_t)[0]

    def _predict_moments(self, test_xn):
        mean, cov = gp_predict(self.cfg, self._gp_params(self.params), self.train_x[None],
                               self.train_t, test_xn[None])
        return mean[0], cov[0]
