"""MAML for few-shot regression (counterpart of meta_learning_pacoh_tpu/algos/maml.py).

The reference's ``MAMLRegression`` (meta_learn/MAML.py): a tanh MLP whose
initialisation is meta-learned. Each task's real points are split in
order: the first ceil(n/2) drive ``num_inner_steps`` inner SGD steps at
``lr_inner``, the rest give the task's MSE after them; the meta-loss is the
mean over the task batch, minimised by Adam or SGD with the staircase lr
schedule of ops/launch_sched.py. The meta-gradient is second order
(MAML.py:210-214): the inner gradients are taken with ``create_graph=True``,
so the meta-gradient flows through the unrolled inner steps. Evaluation
adapts on the whole context set with the plain MSE and reports RMSE only
(MAML.py:148-185).

A task batch of B tasks runs as one pass: the flat parameters expanded to
[B, P], whose gradient of the summed per-task inner losses is each task's
own gradient (what the JAX learner's ``vmap`` gives). The parameters and
Adam moments are flat vectors (``FlatParamsMetaLearned``); a sampled task
batch of global step s is drawn from a CPU generator seeded with (train
seed, s). The step runs no hand-written kernel: its products are small
batched MLPs, as in the JAX package, where they run outside any Pallas
kernel.

``mesh=`` (a ``parallel.make_mesh`` mesh, full batch only) shards the tasks
over the mesh's "task" axis, as the JAX learner's: each rank's loss is its
tasks' outer MSEs summed over the whole batch's task count, and an
all_reduce sums the meta-gradients, so every rank applies the same update.
"""

import time

import numpy as np
import torch

from meta_learning_pacoh_torch.algos.base import FlatParamsMetaLearned
from meta_learning_pacoh_torch.interop import from_jax_maml_state
from meta_learning_pacoh_torch.models.mlp import init_mlp_params, mlp_apply
from meta_learning_pacoh_torch.utils.input_handling import handle_input_dim


def masked_mse(params, x, y, w):
    """Per task: the w-weighted squared error over max(sum of w * dy, 1), the
    training MSE of one half of a task. params leaves [B, ...], x [B, N, D],
    y [B, N, Dy], w [B, N, 1] -> [B]."""
    err = (mlp_apply(params, x) - y) ** 2 * w
    return torch.sum(err, dim=(-2, -1)) / torch.clamp_min(
        torch.sum(w * torch.ones_like(y), dim=(-2, -1)), 1.0)


def plain_mse(params, x, y):
    """Per task: the mean squared error over all points, the evaluation's
    adaptation loss -> [B]."""
    return torch.mean((mlp_apply(params, x) - y) ** 2, dim=(-2, -1))


def inner_adapt(params, x, y, lr_inner, num_steps):
    """``num_steps`` SGD steps at ``lr_inner`` on the plain MSE of one task
    from ``params`` (an MLP parameter dict, leaves without a particle axis;
    x [N, D], y [N, Dy]); returns the adapted dict.

    Differentiable through the unroll: each inner gradient is taken with
    ``create_graph=True``, so a loss of the adapted parameters has its
    gradient with respect to ``params`` to second order, as ``jax.grad``
    through the JAX function's scan. The learner's own steps
    (``_meta_loss``, ``_adapt_and_predict``) adapt a batch of tasks at once
    on the flat [B, P] layout and do not call it.
    """
    names = list(params)
    leaves = [w if w.requires_grad else w.detach().requires_grad_(True)
              for w in (params[k] for k in names)]
    for _ in range(num_steps):
        out = mlp_apply({k: w[None] for k, w in zip(names, leaves)}, x[None])[0]
        grads = torch.autograd.grad(torch.mean((out - y) ** 2), leaves, create_graph=True)
        leaves = [w - lr_inner * g for w, g in zip(leaves, grads)]
    return dict(zip(names, leaves))


class MAMLRegression(FlatParamsMetaLearned):

    from_jax_state = staticmethod(from_jax_maml_state)

    def __init__(self, meta_train_data, layer_sizes=(32, 32, 32, 32), num_iter_fit=20000,
                 lr_inner=0.05, num_inner_steps=1, task_batch_size=5, lr_meta=1e-3,
                 lr_decay=1.0, optimizer="Adam", normalize_data=True, random_seed=None,
                 mesh=None, device=None):
        """mesh: a ``parallel.make_mesh`` mesh with a "task" axis, of the
        learner's device type; requires task_batch_size=-1 (full batch).
        device: where the parameters, the data and the computation live
        ('cuda', 'cpu', a torch.device); None means the card, and raises
        without one."""
        super().__init__(normalize_data, random_seed, device)
        self._check_and_set_dims(meta_train_data)
        self._compute_normalization_stats(meta_train_data)
        self.X, self.Y, self.mask = self._prepare_meta_data(meta_train_data)
        self.n_tasks = self.X.shape[0]
        self.task_batch_size = self.n_tasks if task_batch_size < 1 else task_batch_size
        self._shard_tasks(mesh, self.task_batch_size == self.n_tasks)
        self.lr_inner = lr_inner
        self.num_inner_steps = num_inner_steps
        self.num_iter_fit = num_iter_fit

        params = init_mlp_params(self._generator, self.input_dim, self.output_dim,
                                 tuple(layer_sizes), scheme="torch_linear")
        self._init_flat_params(params, optimizer, lr_meta, lr_decay)

        # each task's split index ceil(n / 2) over its real points (ragged tasks
        # keep their real points first; the reference splits by order, MAML.py:203)
        split = torch.ceil(self.mask.sum(dim=1) / 2.0)
        pos = torch.arange(self.X.shape[1], device=self.device)
        self._w_inner = ((pos < split[:, None]).float() * self.mask)[..., None]
        self._w_outer = ((pos >= split[:, None]).float() * self.mask)[..., None]

    def _prepare_meta_data(self, meta_train_tuples):
        """(X [T, N, D], Y [T, N, Dy], mask [T, N]) on the device, normalised and
        zero-padded; MAML keeps y 2-D (output_dim may exceed 1)."""
        tasks = [handle_input_dim(x, y) for x, y in meta_train_tuples]
        n_max = max(x.shape[0] for x, _ in tasks)
        t, d, dy = len(tasks), tasks[0][0].shape[1], tasks[0][1].shape[1]
        X = np.zeros((t, n_max, d), np.float32)
        Y = np.zeros((t, n_max, dy), np.float32)
        mask = np.zeros((t, n_max), np.float32)
        for i, (x, y) in enumerate(tasks):
            X[i, : x.shape[0]] = self._normalize_x(x)
            Y[i, : x.shape[0]] = self._normalize_y(y)
            mask[i, : x.shape[0]] = 1.0
        return self._tensor(X), self._tensor(Y), self._tensor(mask)

    # ------------------------------------------------------------ train step
    def _task_draw(self, step):
        """Task indices (a CPU tensor) of the sampled batch of global step ``step``."""
        return torch.randint(0, self.n_tasks, (self.task_batch_size,),
                             generator=self._step_generator(step))

    def _meta_loss(self, flat, X, Y, w_inner, w_outer):
        """The mean over the batch of each task's outer-half MSE after its
        inner steps on the inner half, differentiable through the unroll.
        Stacked: flat [S, P], the data [S, B, ...] -> [S], all S B tasks
        adapted in one pass."""
        lead, b = flat.shape[:-1], X.shape[-3]
        adapted = flat[..., None, :].expand(*lead, b, flat.shape[-1]).reshape(
            -1, flat.shape[-1])
        X, Y = X.reshape(-1, *X.shape[-2:]), Y.reshape(-1, *Y.shape[-2:])
        w_inner, w_outer = (w.reshape(-1, *w.shape[-2:]) for w in (w_inner, w_outer))
        for _ in range(self.num_inner_steps):
            inner = torch.sum(masked_mse(self._param_tree(adapted), X, Y, w_inner))
            (grad,) = torch.autograd.grad(inner, adapted, create_graph=True)
            adapted = adapted - self.lr_inner * grad
        outer = masked_mse(self._param_tree(adapted), X, Y, w_outer).reshape(*lead, b)
        if self._shard is not None:  # this rank's share of the whole batch's mean
            return torch.sum(outer, dim=-1) / self.n_tasks
        return torch.mean(outer, dim=-1)

    def _grad(self, params, data):
        """(loss, its gradient) at params [..., P], the loss summed over the fits."""
        flat = params.detach().requires_grad_(True)
        loss = self._meta_loss(flat, *data)
        (grad,) = torch.autograd.grad(loss.sum(), flat)
        return loss.detach(), grad

    def _step(self):
        """One meta-step; returns its loss (a device scalar)."""
        data = (self.X, self.Y, self._w_inner, self._w_outer)
        if self.task_batch_size != self.n_tasks:
            idx = self._task_draw(self._step_count).to(self.device)
            data = tuple(a[idx] for a in data)
        loss, grad = self._grad(self.params, data)
        if self._shard is not None:
            self._shard.all_reduce_(loss, grad)
        self._apply_update(grad)
        self._step_count += 1
        return loss

    def _stacked_step(self, stack):
        """One meta-step of S stacked fits (``parallel.seed_parallel.SeedStack``:
        params [S, P], each fit with its own data, task draws and lr), in
        place; returns the losses [S]."""
        data = stack.data
        if self.task_batch_size != self.n_tasks:
            data = stack.gather(data, [m._task_draw(stack.step) for m in stack.models])
        loss, grad = self._grad(stack.state["params"], data)
        self._stacked_update(stack, grad)
        return loss

    def meta_fit(self, valid_tuples=None, verbose=True, log_period=500, n_iter=None):
        """Meta-learns the initialisation. Returns the last step's loss."""
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
                    message += " Valid-RMSE: %.3f " % self.eval_datasets(valid_tuples)
                if verbose:
                    self.logger.info(message)
        self.fitted = True
        return float("nan") if last is None else float(last)

    # --------------------------------------------------------------- predict
    def _adapt_and_predict(self, CX, CY, TX, num_steps):
        """Adapted and initial predictions [B, Nt, Dy] in normalised units:
        ``num_steps`` SGD steps at ``lr_inner`` on each task's plain context
        MSE. The inner gradients are taken under ``enable_grad``, so this
        also runs inside ``torch.no_grad``."""
        initial = self.params.detach().expand(CX.shape[0], -1)
        adapted = initial.clone()
        with torch.enable_grad():
            for _ in range(num_steps):
                adapted.requires_grad_(True)
                loss = torch.sum(plain_mse(self._param_tree(adapted), CX, CY))
                (grad,) = torch.autograd.grad(loss, adapted)
                adapted = (adapted - self.lr_inner * grad).detach()
        with torch.no_grad():
            return (mlp_apply(self._param_tree(adapted), TX),
                    mlp_apply(self._param_tree(initial), TX))

    def predict(self, context_x, context_y, test_x, num_steps_eval=None):
        """Adapts on the context; (adapted, initial) test means, in original y units."""
        num_steps_eval = self.num_inner_steps if num_steps_eval is None else num_steps_eval
        context_x, context_y = handle_input_dim(context_x, context_y)
        test_x = handle_input_dim(test_x)
        if test_x.shape[1] != context_x.shape[1]:
            raise ValueError("test_x and context_x differ in input dimension")
        cx = self._tensor(self._normalize_x(context_x))[None]
        cy = self._tensor(self._normalize_y(context_y))[None]
        tx = self._tensor(self._normalize_x(test_x))[None]
        adapted, initial = self._adapt_and_predict(cx, cy, tx, num_steps_eval)

        def unnorm(y):
            return y[0].cpu().numpy() * self.y_std[None, :] + self.y_mean[None, :]

        return unnorm(adapted), unnorm(initial)

    def eval(self, context_x, context_y, test_x, test_y, num_steps_eval=None):
        """RMSE after adaptation (reference: MAML.py:148-170), a single float."""
        test_x, test_y = handle_input_dim(test_x, test_y)
        y_pred, _ = self.predict(context_x, context_y, test_x, num_steps_eval=num_steps_eval)
        return float(np.sqrt(np.mean(np.sum((y_pred - test_y) ** 2, axis=-1))))

    def eval_datasets(self, test_tuples, num_steps_eval=None, **kwargs):
        """The mean over tasks of the adapted RMSE, a single float. Tasks of one
        shape adapt and predict in one batched pass; ragged ones one by one."""
        if not all(len(t) == 4 for t in test_tuples):
            raise ValueError("test tuples must be (ctx_x, ctx_y, test_x, test_y)")
        num_steps_eval = self.num_inner_steps if num_steps_eval is None else num_steps_eval
        prepared = [handle_input_dim(a, b) + handle_input_dim(c, d)
                    for a, b, c, d in test_tuples]
        if len({(cx.shape, tx.shape) for cx, _, tx, _ in prepared}) != 1:
            return float(np.mean([self.eval(*t, num_steps_eval=num_steps_eval, **kwargs)
                                  for t in test_tuples]))
        CX, CY, TX, TY = (self._tensor(np.stack(a)) for a in zip(*[
            (self._normalize_x(cx), self._normalize_y(cy), self._normalize_x(tx), ty)
            for cx, cy, tx, ty in prepared]))
        adapted, _ = self._adapt_and_predict(CX, CY, TX, num_steps_eval)
        pred = adapted * self._tensor(self.y_std) + self._tensor(self.y_mean)
        rmses = torch.sqrt(torch.mean(torch.sum((pred - TY) ** 2, dim=-1), dim=-1))
        return float(torch.mean(rmses))
