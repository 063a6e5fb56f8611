"""Task environments of the benchmark's traffic: frozen numpy copies of the
port's ``SinusoidDataset`` and ``CauchyDataset``
(meta_learning_pacoh_torch/datasets/data_sim.py), the task distributions of
the reference paper's sinusoid and Cauchy environments.

They are copied, not imported, so that the inputs a seed gives stay the same
whatever a later change does to the program's data module. The draws are made
in the original's order, except the sinusoid's meta-test sets, drawn for all
their tasks at once (the same distribution), since a meta-test cell draws
hundreds of sets in its set-up.
"""

import numpy as np
from scipy.stats import truncnorm


class SinusoidEnv:
    """f(x) = slope x + amp sin(period (x - x_shift)) + y_shift, amp ~ U(0.7, 1.3),
    slope ~ N(0.5, 0.2), x_shift ~ N(0, 0.1), y_shift ~ N(5, 0.1), period 1.5,
    x ~ U(-5, 5), observation noise N(0, 0.1^2); inputs of one dimension."""

    dim = 1

    def __init__(self, random_state):
        self.rs = random_state

    def _task(self, n):
        rs = self.rs
        amp = rs.uniform(0.7, 1.3)
        x_shift = rs.normal(0.0, 0.1)
        y_shift = rs.normal(5.0, 0.1)
        slope = rs.normal(0.5, 0.2)
        period = rs.uniform(1.5, 1.5)
        x = rs.uniform(-5, 5, size=(n, 1))
        f = slope * x + amp * np.sin(period * (x - x_shift)) + y_shift
        return x, f + 0.1 * rs.normal(size=(n, 1))

    def meta_train(self, n_tasks, n_samples):
        return [self._task(n_samples) for _ in range(n_tasks)]

    def meta_test(self, n_tasks, n_context, n_test):
        """n_tasks (context x, context y, test x, test y) of n_context and
        n_test points: the tasks of ``_task``, drawn for all tasks at once
        (each parameter, then the inputs, then the noise), so that a set of
        hundreds of tasks takes about a millisecond."""
        rs, n = self.rs, n_context + n_test
        amp = rs.uniform(0.7, 1.3, size=(n_tasks, 1, 1))
        x_shift = rs.normal(0.0, 0.1, size=(n_tasks, 1, 1))
        y_shift = rs.normal(5.0, 0.1, size=(n_tasks, 1, 1))
        slope = rs.normal(0.5, 0.2, size=(n_tasks, 1, 1))
        x = rs.uniform(-5, 5, size=(n_tasks, n, 1))
        y = slope * x + amp * np.sin(1.5 * (x - x_shift)) + y_shift \
            + 0.1 * rs.normal(size=(n_tasks, n, 1))
        x, y = x.astype(np.float32), y.astype(np.float32)
        return [(xs[:n_context], ys[:n_context], xs[n_context:], ys[n_context:])
                for xs, ys in zip(x, y)]


class CauchyEnv(SinusoidEnv):
    """Two Cauchy bumps, 6 c(x; -1) + 3 c(x; 2) + 1, plus an SE-GP residual of
    scale 0.2 and lengthscale 0.5; x ~ N(0, 2.5^2) truncated to [-7.5, 5] in
    each of two dimensions; observation noise N(0, 0.05^2)."""

    dim = 2

    def _mean(self, x):
        c1 = 1.0 / (np.pi * (1 + np.linalg.norm(x + 1.0, axis=-1) ** 2))
        c2 = 1.0 / (np.pi * (1 + np.linalg.norm(x - 2.0, axis=-1) ** 2))
        return 6 * c1 + 3 * c2 + 1

    def meta_test(self, n_tasks, n_context, n_test):
        out = []
        for _ in range(n_tasks):
            x, y = self._task(n_context + n_test)
            out.append((x[:n_context], y[:n_context], x[n_context:], y[n_context:]))
        return out

    def _task(self, n):
        x = truncnorm.rvs(-3, 2, loc=0, scale=2.5, size=(n, self.dim), random_state=self.rs)
        sq = np.sum(x ** 2, 1)[:, None] + np.sum(x ** 2, 1)[None, :] - 2 * x @ x.T
        chol = np.linalg.cholesky(np.exp(-0.5 * sq / 0.5) + 1e-8 * np.eye(n))
        f = self._mean(x) + (chol @ self.rs.normal(scale=0.2, size=(n, 1))).flatten()
        y = f + self.rs.normal(scale=0.05, size=f.shape)
        return x, y.reshape(-1, 1)


ENVS = {"sinusoid": SinusoidEnv, "cauchy": CauchyEnv}


def environment(name, seed):
    """The environment ``name`` drawing from ``RandomState(seed + 1)``, the
    seeding rule of the port's ``provide_data`` (taken modulo 2**32, the
    range numpy's generator takes)."""
    return ENVS[name](np.random.RandomState((int(seed) + 1) % 2 ** 32))


def as_float32(tasks):
    """The tasks' arrays as float32, the inputs handed alike to the program
    and to the reference."""
    return [tuple(np.asarray(a, np.float32) for a in task) for task in tasks]
