"""Base classes: data handling, normalisation, evaluation (counterpart of meta_learning_pacoh_tpu/algos/base.py).

Global z-score normalisation pooled over all meta-train tasks; the average
test log-likelihood is the joint predictive log-density / n_test; RMSE; the
calibration error is the RMSE between empirical CDF frequencies and 20
confidence levels in [0.05, 0.95].

Statistics are kept in numpy on the host; data tensors live on the
learner's ``device``. Seeding is an explicit CPU ``torch.Generator`` seeded
from ``random_seed``, so a seed draws the same numbers on every device.
"""

import numpy as np
import torch

from meta_learning_pacoh_torch.utils.input_handling import handle_input_dim, stack_task_tuples
from meta_learning_pacoh_torch.utils.logging import get_logger


class RegressionModelBase:
    """Shared normalisation and evaluation logic."""

    def __init__(self, normalize_data=True, random_seed=None, device=None):
        self.normalize_data = normalize_data
        self.logger = get_logger()
        self.input_dim = None
        self.output_dim = None
        self.device = torch.device("cpu" if device is None else device)
        self.random_seed = 0 if random_seed is None else int(random_seed)
        self._generator = torch.Generator().manual_seed(self.random_seed)
        self.fitted = False

    def _tensor(self, a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=self.device)

    # -- normalisation ----------------------------------------------------
    def _set_normalization_stats(self, X, Y):
        if self.normalize_data:
            self.x_mean = np.mean(X, axis=0)
            self.y_mean = np.mean(Y, axis=0)
            self.x_std = np.std(X, axis=0) + 1e-8
            self.y_std = np.std(Y, axis=0) + 1e-8
        else:
            self.x_mean, self.y_mean = np.zeros(X.shape[1]), np.zeros(Y.shape[1])
            self.x_std, self.y_std = np.ones(X.shape[1]), np.ones(Y.shape[1])

    def _compute_normalization_stats(self, meta_train_tuples):
        xs, ys = zip(*[handle_input_dim(x, y) for x, y in meta_train_tuples])
        self._set_normalization_stats(np.concatenate(xs, 0), np.concatenate(ys, 0))

    def _normalize_x(self, X):
        return ((X - self.x_mean[None, :]) / self.x_std[None, :]).astype(np.float32)

    def _normalize_y(self, Y):
        return ((Y - self.y_mean[None, :]) / self.y_std[None, :]).astype(np.float32)

    def _prepare_data_per_task(self, x, y):
        """(x [N, D], y [N]) normalised, as tensors on the device."""
        x, y = handle_input_dim(x, y)
        return self._tensor(self._normalize_x(x)), self._tensor(self._normalize_y(y)[:, 0])

    def _prepare_meta_data(self, meta_train_tuples):
        """Stack, normalise, pad -> (X [T, N, D], Y [T, N], mask [T, N]) on the device."""
        X, Y, mask = stack_task_tuples(meta_train_tuples)
        Xn = (X - self.x_mean[None, None, :]) / self.x_std[None, None, :]
        Yn = (Y - self.y_mean[0]) / self.y_std[0]
        Xn = Xn * mask[..., None]
        Yn = Yn * mask
        return self._tensor(Xn), self._tensor(Yn), self._tensor(mask)


class RegressionModelMetaLearned(RegressionModelBase):
    """Base of the meta-learners: predict(context_x, context_y, test_x)."""

    def _check_and_set_dims(self, meta_train_data):
        shapes = [handle_input_dim(x, y) for x, y in meta_train_data]
        self.input_dim = shapes[0][0].shape[-1]
        self.output_dim = shapes[0][1].shape[-1]
        if not all(x.shape[-1] == self.input_dim and y.shape[-1] == self.output_dim
                   for x, y in shapes):
            raise ValueError("all tasks must share input/output dimensionality")

    def _run_batch_eval(self, CX, CY, TX, TY):
        """(ll [T], rmse [T], calib [T]) of stacked test tasks."""
        raise NotImplementedError

    def eval(self, context_x, context_y, test_x, test_y):
        """(avg_log_likelihood, rmse, calibration_error) on one test task."""
        return self.eval_datasets([(context_x, context_y, test_x, test_y)])

    def _stack_eval_tuples(self, test_tuples):
        """Uniform-shape test tuples as tensors (ctx_x, ctx_y normalised;
        test_x normalised; test_y raw), or None if their shapes differ."""
        prepared = []
        for cx, cy, tx, ty in test_tuples:
            cx, cy = handle_input_dim(cx, cy)
            tx, ty = handle_input_dim(tx, ty)
            prepared.append((cx, cy, tx, ty))
        if len({(cx.shape, tx.shape) for cx, _, tx, _ in prepared}) != 1:
            return None
        CX = np.stack([self._normalize_x(cx) for cx, _, _, _ in prepared])
        CY = np.stack([self._normalize_y(cy)[:, 0] for _, cy, _, _ in prepared])
        TX = np.stack([self._normalize_x(tx) for _, _, tx, _ in prepared])
        TY = np.stack([ty[:, 0] for _, _, _, ty in prepared])
        return tuple(self._tensor(a) for a in (CX, CY, TX, TY))

    def eval_datasets(self, test_tuples):
        """Mean (ll, rmse, calib) over (ctx_x, ctx_y, test_x, test_y) tuples.

        Tasks of one shape evaluate in one batched call; ragged ones one by one.
        """
        if not all(len(t) == 4 for t in test_tuples):
            raise ValueError("test tuples must be (ctx_x, ctx_y, test_x, test_y)")
        stacked = self._stack_eval_tuples(test_tuples)
        if stacked is not None:
            lls, rmses, calibs = self._run_batch_eval(*stacked)
            return (float(torch.mean(lls)), float(torch.mean(rmses)),
                    float(torch.mean(calibs)))
        results = [self.eval_datasets([t]) for t in test_tuples]
        ll, rmse, calib = zip(*results)
        return float(np.mean(ll)), float(np.mean(rmse)), float(np.mean(calib))
