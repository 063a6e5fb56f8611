"""The port's PACOH-SVGD slice against the JAX learner, from identical state.

The JAX learner runs its general step with the Pallas kernels in interpret
mode (PACOH_TPU_FORCE_PALLAS=1) and the fused training kernels off
(PACOH_TPU_DISABLE_FUSED=1): the Stein kernel, the MLL kernel (N=12) and,
at eval, the blocked Cholesky (70 test points). The port takes the JAX
learner's particles and Adam state, both run five full-batch steps, and the
particles, predictions and eval metrics are compared. The kernel net's
output bias is left out of the particle comparison: its true gradient is
exactly zero, so both sides random-walk float noise there.
"""

import numpy as np
import pytest
import torch

from meta_learning_pacoh_tpu import GPRegressionMetaLearnedSVGD as JaxSVGD
from meta_learning_pacoh_tpu.utils import jit_cache
from meta_learning_pacoh_torch import GPRegressionMetaLearnedSVGD
from meta_learning_pacoh_torch.datasets import CauchyDataset

KW = dict(num_particles=4, mean_nn_layers=(8, 8), kernel_nn_layers=(8, 8), random_seed=30)


@pytest.fixture
def pallas_general_step(monkeypatch):
    # the shared() jit cache keys ignore these flags: clear it around the test
    monkeypatch.setenv("PACOH_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("PACOH_TPU_DISABLE_FUSED", "1")
    jit_cache.clear()
    yield
    jit_cache.clear()


def _cauchy(n_tasks=4, n_samples=12, n_test=70):
    env = CauchyDataset(random_state=np.random.RandomState(5))
    train = env.generate_meta_train_data(n_tasks=n_tasks, n_samples=n_samples)
    test = env.generate_meta_test_data(n_tasks=3, n_samples_context=n_samples,
                                       n_samples_test=n_test)
    return train, test


def test_slice_matches_jax_learner_from_same_state(pallas_general_step):
    """Particles after 5 steps: max difference 1e-4, a tenth of what one step
    can move a coordinate (lr 1e-3), and mean difference 2e-6. Coordinates
    whose gradient nearly cancels differ most: Adam's normalisation turns
    float32 rounding there into a visible step (2.4e-5 measured). Predictions
    and metrics rtol 1e-4 from the same particles, 1e-3 after the steps (the
    particle differences move a predictive mean by up to 1.2e-4)."""
    train, test = _cauchy()
    jax_model = JaxSVGD(train, **KW)
    jax_model.meta_fit(n_iter=3, log_period=3, verbose=False)  # a non-zero Adam state
    port = GPRegressionMetaLearnedSVGD(train, **KW)
    port.load_state_dict(jax_model.state_dict())
    np.testing.assert_array_equal(port.X.numpy(), np.asarray(jax_model.X))
    np.testing.assert_array_equal(port.Y.numpy(), np.asarray(jax_model.Y))
    _assert_same_predictions(port, jax_model, test, rtol=1e-4)

    jax_model.meta_fit(n_iter=5, log_period=5, verbose=False)
    port.meta_fit(n_iter=5, log_period=5, verbose=False)
    assert port.state_dict()["step"] == jax_model.state_dict()["step"] == 8

    keep = np.ones(port.hyper_prior.dim, bool)
    keep[port.hyper_prior.slice_of(("kernel_nn", "b_out"))] = False
    got, want = port.particles.numpy(), np.asarray(jax_model.particles)
    diff = np.abs(got[:, keep] - want[:, keep])
    assert diff.max() <= 1e-4 and diff.mean() <= 2e-6, (diff.max(), diff.mean())
    _assert_same_predictions(port, jax_model, test, rtol=1e-3)


def _assert_same_predictions(port, jax_model, test, rtol):
    mean, std = port.predict(*test[0][:3])
    mean_j, std_j = jax_model.predict(*test[0][:3])
    np.testing.assert_allclose(mean, mean_j, rtol=rtol)
    np.testing.assert_allclose(std, std_j, rtol=rtol)
    np.testing.assert_allclose(port.eval_datasets(test), jax_model.eval_datasets(test),
                               rtol=rtol, atol=1e-5)


def test_fit_is_deterministic_across_chunkings_and_resumes():
    """Sampled task batches depend on (seed, step) only: one chunk, three
    chunks, and a state_dict round trip mid-fit give identical particles."""
    train, _ = _cauchy(n_tasks=6, n_samples=6)
    kw = dict(KW, task_batch_size=3)
    one = GPRegressionMetaLearnedSVGD(train, **kw)
    one.meta_fit(n_iter=6, log_period=6, verbose=False)
    chunked = GPRegressionMetaLearnedSVGD(train, **kw)
    chunked.meta_fit(n_iter=6, log_period=2, verbose=False)
    resumed = GPRegressionMetaLearnedSVGD(train, **kw)
    resumed.meta_fit(n_iter=3, verbose=False)
    fresh = GPRegressionMetaLearnedSVGD(train, **kw)
    fresh.load_state_dict(resumed.state_dict())
    fresh.meta_fit(n_iter=3, verbose=False)
    assert torch.equal(one.particles, chunked.particles)
    assert torch.equal(one.particles, fresh.particles)
    assert torch.isfinite(one.particles).all()
