"""Base classes: data handling, normalisation, evaluation (counterpart of meta_learning_pacoh_tpu/algos/base.py).

Global z-score normalisation pooled over all meta-train tasks; the average
test log-likelihood is the joint predictive log-density / n_test; RMSE; the
calibration error is the RMSE between empirical CDF frequencies and 20
confidence levels in [0.05, 0.95].

Statistics are kept in numpy on the host; data tensors live on the
learner's ``device``, the card unless the caller names another
(``device="cpu"``). Seeding is an explicit CPU ``torch.Generator`` seeded
from ``random_seed``, so a seed draws the same numbers on every device.
"""

import contextlib

import numpy as np
import torch

from meta_learning_pacoh_torch.models.random_gp import ravel_flat, tree_layout, unravel_flat
from meta_learning_pacoh_torch.ops import cuda, gp as gp_ops, launch_sched
from meta_learning_pacoh_torch.ops.cuda.blocked_mll_kernel import BLOCKED_MAX_N
from meta_learning_pacoh_torch.ops.metrics import calib_error_from_cdf
from meta_learning_pacoh_torch.parallel import mesh as mesh_ops
from meta_learning_pacoh_torch.utils.input_handling import handle_input_dim, stack_task_tuples
from meta_learning_pacoh_torch.utils.logging import get_logger
from meta_learning_pacoh_torch.utils.profiling import LEARNER_PREPARE, spanned


def calib_error(pred_dist_vectorized, test_y):
    """Calibration error of a vectorised predictive at the test targets: the
    RMSE between the empirical frequencies of its cdf at 20 levels in
    [0.05, 0.95] and the levels, a float."""
    cdf = pred_dist_vectorized.cdf(torch.as_tensor(
        test_y, dtype=pred_dist_vectorized.mean.dtype,
        device=pred_dist_vectorized.mean.device).flatten())
    return float(calib_error_from_cdf(cdf.flatten()))


def resolve_device(device):
    """The learner's device: ``None`` means the card, and raises without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the learners run on the card by default; "
                               "pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def tier_mesh(mesh, n):
    """``mesh`` where a learner's Gram matrices of ``n`` points go through
    the distributed tier (its "task" axis factors each matrix together:
    ``ops.gp.distributed_linalg``), else None: more than BLOCKED_MAX_N
    points and a "task" axis, as the JAX learners decide."""
    if mesh is not None and "task" in mesh.mesh_dim_names and n > BLOCKED_MAX_N:
        return mesh
    return None


def tier_ctx(mesh):
    """The distributed tier on ``mesh`` (a ``tier_mesh``), or no context for None."""
    return contextlib.nullcontext() if mesh is None else gp_ops.distributed_linalg(mesh)


def check_choice(name, value, choices):
    """Raise a ValueError unless a constructor argument is one of ``choices``."""
    if value not in choices:
        raise ValueError(f"{name} must be one of {choices}, got {value!r}")


class TaskShard:
    """A rank's share of the task axis of a learner built with ``mesh=``
    (the JAX learners' ``shard_task_batch``): the contiguous slice ``rows``
    of the T meta-train tasks, the process group of the mesh's task axis,
    and ``lead``, whether this rank is the axis's first.

    Each rank computes the data term of the loss on its own tasks, scaled
    by the whole batch's normalisers (its task count, its harmonic mean);
    the terms that are no sum over tasks (a hyper-prior, an entropy, a
    meta-complexity) enter on the lead rank only. ``all_reduce_`` then sums
    the gradients of the replicated state, and the losses, over the axis in
    one collective, so every rank applies the same update to the same bits.
    """

    def __init__(self, mesh, mask):
        self.group = mesh_ops.axis_group(mesh, "task")
        self.rows = mesh_ops.shard_rows(mesh, mask.shape[0])
        self.lead = mesh_ops.axis_rank(mesh, "task") == 0
        self.sizes = torch.sum(mask, dim=-1)  # [T] real points of every task

    def take(self, *tensors):
        """This rank's rows of tensors [T, ...]."""
        return tuple(t[self.rows] for t in tensors)

    def all_reduce_(self, *tensors):
        """Sum tensors over the task axis in place (one collective)."""
        mesh_ops.all_reduce_(list(tensors), self.group)

    def gather(self, t):
        """All ranks' rows of t [T / D, ...] -> [T, ...]."""
        parts = mesh_ops.all_gather(t, self.group)
        return parts.reshape(-1, *t.shape[1:])


class RegressionModelBase:
    """Shared normalisation and evaluation logic."""

    def __init__(self, normalize_data=True, random_seed=None, device=None):
        self.normalize_data = normalize_data
        self.logger = get_logger()
        self.input_dim = None
        self.output_dim = None
        self.device = resolve_device(device)
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

    def _prepare_data_per_task(self, x, y, flatten_y=True):
        """(x [N, D], y [N]) normalised, as tensors on the device; y [N, 1]
        with ``flatten_y=False``."""
        x, y = handle_input_dim(x, y)
        y = self._normalize_y(y)
        if flatten_y:
            if y.shape[1] != 1:
                raise ValueError(f"y must have one output dimension, got {y.shape[1]}")
            y = y[:, 0]
        return self._tensor(self._normalize_x(x)), self._tensor(y)

    @spanned(LEARNER_PREPARE)
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

    def _shard_tasks(self, mesh, full_batch, replicate=False):
        """``mesh=`` of the constructor: keep this rank's share of the
        meta-train tasks (``self._shard``, a ``TaskShard``, None without a
        mesh, or with ``replicate``: every rank then keeps every task). Needs
        the full batch (task_batch_size=-1), a "task" axis and a mesh of the
        learner's device type, as the JAX learners do."""
        self._mesh, self._shard = mesh, None
        if mesh is None:
            return
        if not full_batch:
            raise ValueError("mesh-sharded training requires task_batch_size=-1 (full batch)")
        self._check_mesh(mesh)
        if replicate:
            return
        self._shard = TaskShard(mesh, self.mask)
        self.X, self.Y, self.mask = self._shard.take(self.X, self.Y, self.mask)

    def _check_mesh(self, mesh):
        if "task" not in mesh.mesh_dim_names:
            raise ValueError(f"the mesh needs a 'task' axis, got {mesh.mesh_dim_names}")
        mesh_ops.check_mesh_device(mesh, self.device)

    def _shard_terms(self):
        """meta_log_prob's keywords of this rank's share of the score."""
        if self._shard is None:
            return {}
        return {"task_sizes": self._shard.sizes, "with_prior": self._shard.lead}

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

    def eval(self, context_x, context_y, test_x, test_y, **kwargs):
        """(avg_log_likelihood, rmse, calibration_error) on one test task.

        Keyword arguments go to ``predict`` (the VI learner's ``mode``, MLAP's
        ``n_iter_meta_test``), and the task is evaluated through the
        predictive density it returns; without them, through the batched path.
        """
        if not kwargs:
            return self.eval_datasets([(context_x, context_y, test_x, test_y)])
        test_x, test_y = handle_input_dim(test_x, test_y)
        y = self._tensor(test_y.flatten())
        pred_dist = self.predict(context_x, context_y, test_x, return_density=True, **kwargs)
        avg_ll = float(torch.mean(pred_dist.log_prob(y))) / y.shape[0]
        rmse = float(torch.sqrt(torch.mean((pred_dist.mean - y) ** 2)))
        calib = calib_error(self._vectorize_pred_dist(pred_dist), y)
        return avg_ll, rmse, calib

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

    def eval_datasets(self, test_tuples, **kwargs):
        """Mean (ll, rmse, calib) over (ctx_x, ctx_y, test_x, test_y) tuples.

        Tasks of one shape evaluate in one batched call, ragged ones one by
        one; with keyword arguments (for ``predict``) every task goes through
        ``eval``, as in the JAX package.
        """
        if not all(len(t) == 4 for t in test_tuples):
            raise ValueError("test tuples must be (ctx_x, ctx_y, test_x, test_y)")
        if kwargs:
            results = [self.eval(*t, **kwargs) for t in test_tuples]
            ll, rmse, calib = zip(*results)
            return float(np.mean(ll)), float(np.mean(rmse)), float(np.mean(calib))
        stacked = self._stack_eval_tuples(test_tuples)
        if stacked is not None:
            lls, rmses, calibs = self._run_batch_eval(*stacked)
            return (float(torch.mean(lls)), float(torch.mean(rmses)),
                    float(torch.mean(calibs)))
        results = [self.eval_datasets([t]) for t in test_tuples]
        ll, rmse, calib = zip(*results)
        return float(np.mean(ll)), float(np.mean(rmse)), float(np.mean(calib))

    def _vectorize_pred_dist(self, pred_dist):
        """The per-point predictive whose ``icdf`` gives the confidence bounds."""
        raise NotImplementedError

    @torch.no_grad()
    def confidence_intervals(self, context_x, context_y, test_x, confidence=0.9, **kwargs):
        """(upper, lower) bounds of the central ``confidence`` interval of the
        per-point predictive at test_x, in original y units; keyword
        arguments go to ``predict``."""
        pred_dist = self._vectorize_pred_dist(
            self.predict(context_x, context_y, test_x, return_density=True, **kwargs))
        alpha = (1.0 - confidence) / 2.0
        n = handle_input_dim(test_x).shape[0]
        q = torch.full((n,), 1.0 - alpha, dtype=torch.float32, device=self.device)
        ucb = pred_dist.icdf(q)
        lcb = pred_dist.icdf(torch.full_like(q, alpha))
        return ucb.cpu().numpy(), lcb.cpu().numpy()


class FlatParamsMetaLearned(RegressionModelMetaLearned):
    """Base of the meta-learners whose parameters are one dict of leaves (MAML's
    net, the Neural Process), held as a flat float32 vector [P] in the
    ``ravel_pytree`` order of the JAX package's dict (``layout``), beside the
    Adam(W) moments; SGD or optax's Adam(W) with the staircase lr schedule.
    The draws of global step s come from a CPU generator seeded with
    (train seed, s), the same numbers on every device and under any chunking.
    ``from_jax_state`` converts a JAX learner's ``state_dict()``. Stacked
    fits (``parallel.fit_models_parallel``) hold the vectors as [S, P]."""

    from_jax_state = None

    def _init_flat_params(self, params, optimizer, lr, lr_decay, weight_decay=0.0):
        check_choice("optimizer", optimizer, ("Adam", "SGD"))
        self._optimizer_name, self._lr, self._lr_decay = optimizer, lr, lr_decay
        self.weight_decay = weight_decay
        self.layout = tree_layout(params)
        self.params = ravel_flat(self.layout, params).to(self.device)
        self._train_seed = int(torch.randint(0, 2 ** 31, (1,), generator=self._generator))
        self._mu = torch.zeros_like(self.params)
        self._nu = torch.zeros_like(self.params)
        self._adam_count = 0
        self._step_count = 0

    def _step_generator(self, step):
        """The CPU generator of global step ``step``'s draws."""
        seed = int(np.random.SeedSequence([self._train_seed, step]).generate_state(1)[0])
        return torch.Generator().manual_seed(seed)

    def _param_tree(self, flat):
        return unravel_flat(self.layout, flat)

    @torch.no_grad()
    def _update(self, params, mu, nu, grad, lr, weight_decay, adam_count):
        """One optax-equivalent SGD or Adam(W) (at step ``adam_count``) step
        on params [..., P], in place; lr and weight_decay numbers or per
        stacked fit [S, 1]."""
        if self._optimizer_name == "SGD":
            params.sub_(lr * grad)
        else:
            cuda.adam_step_(params, mu, nu, grad, adam_count, lr, weight_decay)

    def _apply_update(self, grad):
        """One optax-equivalent SGD or Adam(W) step at the staircase lr, in place."""
        lr = launch_sched.staircase_lr(self._lr, self._lr_decay, self._step_count)
        if self._optimizer_name == "Adam":
            self._adam_count += 1
        self._update(self.params, self._mu, self._nu, grad, lr, self.weight_decay,
                     self._adam_count)

    def _stacked_update(self, stack, grad):
        """The update of S stacked fits' flat parameters [S, P]
        (``parallel.seed_parallel.SeedStack``), each at its own lr and weight
        decay; advances the stack's step."""
        if self._optimizer_name == "Adam":
            stack.adam_count += 1
        self._update(stack.state["params"], stack.state["_mu"], stack.state["_nu"], grad,
                     stack.staircase("_lr")[:, None], stack.per_seed("weight_decay")[:, None],
                     stack.adam_count)
        stack.step += 1

    def state_dict(self):
        def tree(flat):  # copies: the fit updates the vectors in place
            return {k: v.detach().cpu().numpy().copy() for k, v in self._param_tree(flat).items()}

        return {"params": tree(self.params),
                "opt_state": {"mu": tree(self._mu), "nu": tree(self._nu),
                              "count": self._adam_count},
                "step": self._step_count}

    def load_state_dict(self, state_dict):
        """Restore a state of this class or a JAX learner's ``state_dict()``."""
        opt = state_dict["opt_state"]
        if not (isinstance(opt, dict) and "mu" in opt):
            state_dict = type(self).from_jax_state(state_dict)
            opt = state_dict["opt_state"]

        def flat(tree):
            return ravel_flat(self.layout, {k: torch.as_tensor(np.asarray(v, dtype=np.float32))
                                            for k, v in tree.items()}).to(self.device)

        self.params = flat(state_dict["params"])
        self._mu, self._nu = flat(opt["mu"]), flat(opt["nu"])
        self._adam_count = int(opt["count"])
        self._step_count = int(state_dict.get("step", 0))


class RegressionModel(RegressionModelBase):
    """Base of the single-task learners: fit(...), then predict(test_x)."""

    def predict(self, test_x, return_density=False):
        raise NotImplementedError

    def _vectorize_pred_dist(self, pred_dist):
        """The per-point predictive whose ``icdf`` gives the confidence bounds."""
        raise NotImplementedError

    @torch.no_grad()
    def eval(self, test_x, test_y):
        """(avg_log_likelihood, rmse, calibration_error) at the test points:
        the joint predictive log-density / n_test, in original y units."""
        test_x, test_y = handle_input_dim(test_x, test_y)
        y = self._tensor(test_y.flatten())
        pred_dist = self.predict(test_x, return_density=True)
        avg_ll = float(pred_dist.log_prob(y)) / y.shape[0]
        rmse = float(torch.sqrt(torch.mean((pred_dist.mean - y) ** 2)))
        calib = calib_error(self._vectorize_pred_dist(pred_dist), y)
        return avg_ll, rmse, calib

    @torch.no_grad()
    def confidence_intervals(self, test_x, confidence=0.9):
        """(upper, lower) bounds of the central ``confidence`` interval of the
        per-point predictive at test_x, in original y units."""
        pred_dist = self._vectorize_pred_dist(self.predict(test_x, return_density=True))
        alpha = (1.0 - confidence) / 2.0
        n = handle_input_dim(test_x).shape[0]
        q = torch.full((n,), 1.0 - alpha, dtype=torch.float32, device=self.device)
        ucb = pred_dist.icdf(q)
        lcb = pred_dist.icdf(torch.full_like(q, alpha))
        return ucb.cpu().numpy(), lcb.cpu().numpy()
