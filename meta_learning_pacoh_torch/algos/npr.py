"""Neural Process meta-learner (counterpart of meta_learning_pacoh_tpu/algos/npr.py).

The reference's ``NPRegressionMetaLearned`` (meta_learn/NPR_meta.py): a
per-task ELBO whose context is a random subset of the target set, the sum
over a task batch minimised by AdamW (or SGD) with the staircase lr
schedule of ops/launch_sched.py, and stochastic prediction with
z ~ q(z | context). The reference constructor swaps ``context_split_ratio``
and ``weight_decay`` when storing them (NPR_meta.py:45); here, as in the
JAX package, the names mean what they say.

The parameters and the AdamW moments are flat vectors (``FlatParamsMetaLearned``).
The draws of global step s (the task batch, a shuffle score vector and a
latent noise a task) come from a CPU generator seeded with (train seed,
s), so a step draws the same numbers on every device and the trajectory
does not depend on how the steps are chunked. The step runs no
hand-written kernel: its products are small MLPs, as in the JAX package,
where they run outside any Pallas kernel.

``mesh=`` (a ``parallel.make_mesh`` mesh, full batch only) shards the tasks
over the mesh's "task" axis, as the JAX learner's: every rank draws the
whole batch's numbers and keeps its tasks' rows, its loss is its tasks'
ELBO losses, and an all_reduce sums the gradients, so every rank applies
the same update.
"""

import math
import time

import numpy as np
import torch

from meta_learning_pacoh_torch.algos.base import FlatParamsMetaLearned
from meta_learning_pacoh_torch.interop import from_jax_np_state
from meta_learning_pacoh_torch.models.neural_process import (
    init_np_params,
    np_elbo_loss,
    np_predict,
)
from meta_learning_pacoh_torch.ops.distributions import AffineTransformed, Normal
from meta_learning_pacoh_torch.ops.metrics import _normal_cdf, calib_error_from_cdf
from meta_learning_pacoh_torch.utils.input_handling import handle_input_dim

_LOG_2PI = math.log(2.0 * math.pi)


class NPRegressionMetaLearned(FlatParamsMetaLearned):

    from_jax_state = staticmethod(from_jax_np_state)

    def __init__(self, meta_train_data, context_split_ratio=0.5, lr_params=1e-3,
                 r_dim=50, z_dim=50, h_dim=50, num_iter_fit=10000, weight_decay=1e-2,
                 task_batch_size=5, normalize_data=True, optimizer="Adam",
                 lr_decay=1.0, random_seed=None, mesh=None, device=None):
        """mesh: a ``parallel.make_mesh`` mesh with a "task" axis, of the
        learner's device type; requires task_batch_size=-1 (full batch).
        device: where the parameters, the data and the computation live
        ('cuda', 'cpu', a torch.device); None means the card, and raises
        without one."""
        super().__init__(normalize_data, random_seed, device)
        self.num_iter_fit = num_iter_fit
        self.z_dim = z_dim

        self._check_and_set_dims(meta_train_data)
        self._compute_normalization_stats(meta_train_data)
        self.X, Y, self.mask = self._prepare_meta_data(meta_train_data)
        self.Y = Y[..., None]  # y kept 2-D per point
        self.n_tasks = self.X.shape[0]
        self.task_batch_size = self.n_tasks if task_batch_size < 1 else task_batch_size

        # per-task context sizes (tasks may be ragged, reference NPR_meta.py:74-76)
        n_per_task = self.mask.sum(dim=1).cpu().numpy()
        self.num_context_per_task = np.ceil(
            np.float32(context_split_ratio) * n_per_task).astype(np.int32)
        self.num_context = int(self.num_context_per_task[0])
        self._num_context = torch.as_tensor(self.num_context_per_task, dtype=torch.int64,
                                            device=self.device)
        self._shard_tasks(mesh, self.task_batch_size == self.n_tasks)
        if self._shard is not None:
            (self._num_context,) = self._shard.take(self._num_context)

        params = init_np_params(self._generator, self.input_dim, self.output_dim,
                                r_dim=r_dim, z_dim=z_dim, h_dim=h_dim)
        self._init_flat_params(params, optimizer, lr_params, lr_decay, weight_decay)

    # ------------------------------------------------------------ train step
    def _step_draws(self, step):
        """The draws of global step ``step``, as CPU tensors: the task indices
        [B] (None for the full batch), the shuffle scores u [B, N] and the
        latent noise eps [B, z_dim]."""
        gen = self._step_generator(step)
        idx = None
        if self.task_batch_size != self.n_tasks:
            idx = torch.randint(0, self.n_tasks, (self.task_batch_size,), generator=gen)
        u = torch.rand(self.task_batch_size, self.X.shape[1], generator=gen)
        eps = torch.randn(self.task_batch_size, self.z_dim, generator=gen)
        return idx, u, eps

    def _grad(self, params, u, eps, data):
        """(loss, its gradient) at params [..., P]: the loss the sum of the
        batch's ELBO losses, [S] stacked (the data and draws [S, B, ...]),
        summed over the fits for the gradient."""
        flat = params.detach().requires_grad_(True)
        X, Y, M, nc = data
        loss = torch.sum(np_elbo_loss(self._param_tree(flat), u.to(self.device),
                                      eps.to(self.device), X, Y, nc, mask=M), dim=-1)
        (grad,) = torch.autograd.grad(loss.sum(), flat)
        return loss.detach(), grad

    def _step(self):
        """One step; returns its loss, the sum of the batch's ELBO losses (a
        device scalar)."""
        idx, u, eps = self._step_draws(self._step_count)
        data = (self.X, self.Y, self.mask, self._num_context)
        if idx is not None:
            idx = idx.to(self.device)
            data = tuple(a[idx] for a in data)
        if self._shard is not None:
            u, eps = self._shard.take(u, eps)
        loss, grad = self._grad(self.params, u, eps, data)
        if self._shard is not None:
            self._shard.all_reduce_(loss, grad)
        self._apply_update(grad)
        self._step_count += 1
        return loss

    def _stacked_step(self, stack):
        """One step of S stacked fits (``parallel.seed_parallel.SeedStack``:
        params [S, P], each fit with its own data, draws, lr and weight
        decay), in place; returns the losses [S]."""
        idx, u, eps = zip(*(m._step_draws(stack.step) for m in stack.models))
        data = stack.data if idx[0] is None else stack.gather(stack.data, idx)
        loss, grad = self._grad(stack.state["params"], torch.stack(u), torch.stack(eps), data)
        self._stacked_update(stack, grad)
        return loss

    def meta_fit(self, valid_tuples=None, verbose=True, log_period=500, n_iter=None):
        """Meta-learns the NP's parameters. Returns the last step's loss."""
        if valid_tuples is not None and not all(len(t) == 4 for t in valid_tuples):
            raise ValueError("valid tuples must be (ctx_x, ctx_y, test_x, test_y)")
        n_iter = self.num_iter_fit if n_iter is None else n_iter
        t = time.time()
        done, last = 0, None
        while done < n_iter:
            chunk = int(min(log_period, n_iter - done))
            losses = torch.stack([self._step() for _ in range(chunk)])
            last = losses[-1]
            done += chunk
            if verbose or valid_tuples is not None:
                message = "Iter %d/%d - Loss: %.6f - Time %.2f sec" % (
                    done, n_iter, float(torch.mean(losses)), time.time() - t)
                t = time.time()
                if valid_tuples is not None:
                    valid_ll, valid_rmse, calib = self.eval_datasets(valid_tuples)
                    message += (" - Valid-LL: %.3f - Valid-RMSE: %.3f - Calib-Err %.3f"
                                % (valid_ll, valid_rmse, calib))
                if verbose:
                    self.logger.info(message)
        self.fitted = True
        return float("nan") if last is None else float(last)

    # --------------------------------------------------------------- predict
    def _eval_eps(self, n):
        """[n, z_dim] standard normals for the latents of n predictions, from
        the learner's generator, on its device."""
        return torch.randn(n, self.z_dim, generator=self._generator).to(self.device)

    @torch.no_grad()
    def _run_batch_eval(self, CX, CY, TX, TY):
        """Per task: avg_ll, the mean per-point log-density (the reference
        evaluates the NP with flatten_y=False, abstract.py:151-157), RMSE and
        calibration, z ~ q(z | context) drawn once a task."""
        mu, sigma = np_predict(self._param_tree(self.params), self._eval_eps(CX.shape[0]), CX,
                               CY[..., None], TX)
        y_mean, y_std = float(self.y_mean[0]), float(self.y_std[0])
        mean_o = y_mean + y_std * mu[..., 0]
        std_o = y_std * sigma[..., 0]
        z = (TY - mean_o) / std_o
        lp = -0.5 * (z ** 2 + _LOG_2PI) - torch.log(std_o)
        rmse = torch.sqrt(torch.mean((mean_o - TY) ** 2, dim=-1))
        return (torch.mean(lp, dim=-1), rmse,
                calib_error_from_cdf(_normal_cdf(TY, mean_o, std_o)))

    @torch.no_grad()
    def predict(self, context_x, context_y, test_x, return_density=False):
        """Stochastic NP prediction (z ~ q(z | context)), in original y units."""
        context_x, context_y = handle_input_dim(context_x, context_y)
        test_x = handle_input_dim(test_x)
        if test_x.shape[1] != context_x.shape[1]:
            raise ValueError("test_x and context_x differ in input dimension")
        cx, cy = self._prepare_data_per_task(context_x, context_y, flatten_y=False)
        tx = self._tensor(self._normalize_x(test_x))
        mu, sigma = np_predict(self._param_tree(self.params), self._eval_eps(1)[0], cx, cy, tx)
        pred_dist = AffineTransformed(Normal(mu[:, 0], sigma[:, 0]), self.y_mean[0],
                                      self.y_std[0])
        if return_density:
            return pred_dist
        return pred_dist.mean.cpu().numpy(), pred_dist.stddev.cpu().numpy()

    @torch.no_grad()
    def eval(self, context_x, context_y, test_x, test_y, **kwargs):
        """(avg_ll, rmse, calib) of one task through ``predict``: avg_ll the
        mean per-point log-density, as the JAX learner's."""
        test_x, test_y = handle_input_dim(test_x, test_y)
        y = self._tensor(test_y.flatten())
        pred_dist = self.predict(context_x, context_y, test_x, return_density=True)
        avg_ll = float(torch.mean(pred_dist.log_prob(y)))
        rmse = float(torch.sqrt(torch.mean((pred_dist.mean - y) ** 2)))
        calib = float(calib_error_from_cdf(self._vectorize_pred_dist(pred_dist).cdf(y)))
        return avg_ll, rmse, calib

    def _vectorize_pred_dist(self, pred_dist):
        return Normal(pred_dist.mean, pred_dist.stddev)
