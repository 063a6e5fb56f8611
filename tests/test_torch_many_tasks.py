"""The fused paths beyond the window of the one-block kernels, against the JAX learners.

At T=128 tasks of N=8 points, nets 16x16 and K = S = 4, every one-block
window is exceeded (copies of their formulas below: at these widths B2's
ended at T=102, B7's at 95, B8's at 68), yet the port's learners take their
fused paths, as the JAX learners take their Pallas kernels at every task
count. On the CPU the fused wrappers run their plain versions; ten steps of
each from the JAX learner's initial state (the port loads its
``state_dict()``), with its own task draws and noise, are held to the JAX
learner's steps (its XLA step on the CPU, as the JAX package's own tests
run it; SVGD's through its Pallas kernel in interpret mode). PACOH-MLAP's
tests are in test_torch_many_tasks_mlap.py. Parameter comparisons leave
out the kernel net's output bias: its true gradient is exactly zero, so
both sides random-walk float noise there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_learning_pacoh_tpu import GPRegressionMetaLearnedSVGD as JaxSVGD
from meta_learning_pacoh_tpu import GPRegressionMetaLearnedVI as JaxVI
from meta_learning_pacoh_tpu.utils import jit_cache
from meta_learning_pacoh_torch import (
    GPRegressionMetaLearnedSVGD,
    GPRegressionMetaLearnedVI,
)
from meta_learning_pacoh_torch.ops.cuda import fused_mlap_kernel as mk
from meta_learning_pacoh_torch.ops.cuda import fused_svgd_kernel as fk

T, N, D, HIDDEN, K = 128, 8, 1, (16, 16), 4
STEPS = 10
SMEM = 232448
NETS = dict(mean_nn_layers=HIDDEN, kernel_nn_layers=HIDDEN)


@pytest.fixture(autouse=True)
def jax_general_step(monkeypatch):
    """The JAX learners' XLA steps; the shared() jit cache keys ignore the
    environment, so it is cleared around every test."""
    for name in ("PACOH_TPU_FORCE_PALLAS", "PACOH_TPU_VI_WEIGHTED", "PACOH_TPU_SVGD_WEIGHTED",
                 "PACOH_TPU_DISABLE_FUSED", "PACOH_TPU_FORCE_BIGN_FUSED",
                 "PACOH_TORCH_DISABLE_FUSED", "PACOH_TORCH_DISABLE_KERNELS"):
        monkeypatch.delenv(name, raising=False)
    jit_cache.clear()
    yield
    jit_cache.clear()


def one_block_windows(count, t, n, d, hidden):
    """(B2, B7, B8): whether the one-block kernels' windows held this shape."""
    p = fk.fused_prior(d, hidden, 1.0, 1.0).dim
    m, h, n_layers = t * n, hidden[0], len(hidden)
    acts = 2 * n_layers * m * h + m * (d + 4)
    return (4 * (2 * p + acts + 2 * t + count * count + count + 8) <= SMEM,
            4 * (8 * p + acts + 3 * t + 32 + 8) <= SMEM,
            4 * (8 * p + 3 * m * (n + 1) + acts + 8 * t + 48) <= SMEM)


def sin_tasks(rs, n_tasks):
    x = rs.uniform(-5.0, 5.0, (n_tasks, N, D))
    y = np.sin(x[..., 0] + rs.uniform(0.0, 3.0, (n_tasks, 1))) + 0.1 * rs.randn(n_tasks, N)
    return list(zip(x, y))


def jax_draws(jax_model, n_steps, n_samples):
    """The JAX learner's task indices [n_steps, batch] and noise [n_steps,
    n_samples, P] of steps 0 .. n_steps - 1 (fold_in, split, randint / normal)."""
    p = jax_model.hyper_prior.dim

    def one(i):
        k_task, k_noise = jax.random.split(jax.random.fold_in(jax_model._train_key, i))
        return (jax.random.randint(k_task, (jax_model.task_batch_size,), 0, jax_model.n_tasks),
                jax.random.normal(k_noise, (n_samples, p), jnp.float32))

    idx, eps = jax.vmap(one)(jnp.arange(n_steps))
    return torch.from_numpy(np.asarray(idx).astype(np.int64)), torch.from_numpy(np.array(eps))


def feed(port, jax_model, n_samples):
    """Give the port the JAX learner's draws of its first STEPS steps."""
    idx, eps = jax_draws(jax_model, STEPS, n_samples)
    port._task_draw = lambda step: idx[step]
    port._draw_eps = lambda step, out: out.copy_(eps[step])


def keep_of(hyper_prior):
    keep = np.ones(hyper_prior.dim, bool)
    keep[hyper_prior.slice_of(("kernel_nn", "b_out"))] = False
    return keep


def test_the_shape_lies_beyond_every_one_block_window():
    """At K = S = 4, N=8, D=1, nets 16x16: the one-block windows end at T=102
    (B2), 95 (B7) and 68 (B8); the kernels' windows now take T=128."""
    assert one_block_windows(K, 102, N, D, HIDDEN)[0]
    assert one_block_windows(K, 95, N, D, HIDDEN)[1]
    assert one_block_windows(K, 68, N, D, HIDDEN)[2]
    assert one_block_windows(K, 103, N, D, HIDDEN)[0] is False
    assert one_block_windows(K, 96, N, D, HIDDEN)[1] is False
    assert one_block_windows(K, 69, N, D, HIDDEN)[2] is False
    assert not any(one_block_windows(K, T, N, D, HIDDEN))
    assert fk.fused_svgd_fits(K, T, N, D, HIDDEN) and mk.fused_mlap_fits(K, T, N, D, HIDDEN)


def test_svgd_fused_path_matches_jax(monkeypatch):
    """Ten full-batch steps of the fused path's plain version against the JAX
    learner's ten through its Pallas kernel in interpret mode (its XLA step
    takes another median: jnp.median, where the kernel and the port take the
    pair distance at rank K*K//2): particles within 1e-4, mean 2e-6 (a tenth
    of one step's reach at lr 1e-3, the card's twin limits; 2.0e-5 and
    7.6e-8 measured: float32 sums of 128 tasks in another order, which
    Adam's normalisation carries into the coordinates of smallest
    gradient)."""
    monkeypatch.setenv("PACOH_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("PACOH_TPU_SVGD_WEIGHTED", "1")
    tasks = sin_tasks(np.random.RandomState(3), T)
    kw = dict(num_particles=K, random_seed=30, **NETS)
    jax_model = JaxSVGD(tasks, **kw)
    port = GPRegressionMetaLearnedSVGD(tasks, device="cpu", **kw)
    port.load_state_dict(jax_model.state_dict())
    assert port._fused_path_ok() and jax_model._fused_path_ok()
    jax_model.meta_fit(n_iter=STEPS, log_period=STEPS, verbose=False)
    port.meta_fit(n_iter=STEPS, log_period=STEPS, verbose=False)
    assert port._fused is not None and jax_model._fused is not None
    keep = keep_of(port.hyper_prior)
    diff = np.abs(port.particles.numpy() - np.asarray(jax_model.particles))[:, keep]
    assert diff.max() <= 1e-4 and diff.mean() <= 2e-6, (diff.max(), diff.mean())


def test_vi_fused_path_matches_jax():
    """Ten steps of the fused path's plain version with the JAX learner's noise
    and task draws against the JAX learner's ten: the last loss rtol 1e-5, the
    posterior atol 1e-5 (the sin_20 VI test's limits)."""
    tasks = sin_tasks(np.random.RandomState(4), T)
    kw = dict(svi_batch_size=K, random_seed=30, **NETS)
    jax_model = JaxVI(tasks, **kw)
    port = GPRegressionMetaLearnedVI(tasks, device="cpu", **kw)
    port.load_state_dict(jax_model.state_dict())
    feed(port, jax_model, K)
    assert port._fused_path_ok()
    want = jax_model.meta_fit(n_iter=STEPS, log_period=STEPS, verbose=False)
    got = port.meta_fit(n_iter=STEPS, log_period=STEPS, verbose=False)
    assert port._fused is not None
    np.testing.assert_allclose(got, want, rtol=1e-5)
    keep = keep_of(port.hyper_prior)
    for key in ("loc", "log_scale"):
        np.testing.assert_allclose(port.posterior[key].numpy()[keep],
                                   np.asarray(jax_model.posterior[key])[keep], rtol=0, atol=1e-5)
