"""The base class's evaluation surface takes keyword arguments for ``predict``.

``eval``, ``eval_datasets`` and ``confidence_intervals`` pass their keyword
arguments to ``predict`` and then evaluate task by task through the
predictive density it returns, as the JAX package's base class does
(JAX algos/base.py: eval, eval_datasets, confidence_intervals). Held here
against the JAX VI learner in MAP mode (deterministic: the GP at the
posterior's loc) from one state: LL, RMSE, calibration and the interval
bounds rtol 1e-5.
"""

import numpy as np
import pytest

from meta_learning_pacoh_tpu import GPRegressionMetaLearnedVI as JaxVI
from meta_learning_pacoh_tpu.utils import jit_cache
from meta_learning_pacoh_torch import GPRegressionMetaLearnedVI
from meta_learning_pacoh_torch.datasets import SinusoidDataset

KW = dict(svi_batch_size=4, mean_nn_layers=(8, 8), kernel_nn_layers=(8, 8), random_seed=30)


@pytest.fixture(autouse=True)
def clear_jit_cache():
    jit_cache.clear()
    yield
    jit_cache.clear()


def _pair():
    env = SinusoidDataset(random_state=np.random.RandomState(26))
    train = env.generate_meta_train_data(n_tasks=6, n_samples=5)
    test = env.generate_meta_test_data(n_tasks=3, n_samples_context=5, n_samples_test=20)
    jax_model = JaxVI(train, **KW)
    jax_model.meta_fit(n_iter=4, log_period=4, verbose=False)
    port = GPRegressionMetaLearnedVI(train, device="cpu", **KW)
    port.load_state_dict(jax_model.state_dict())
    return jax_model, port, test


def test_eval_datasets_and_eval_take_predict_keywords():
    jax_model, port, test = _pair()
    want = jax_model.eval_datasets(test, mode="MAP")
    np.testing.assert_allclose(port.eval_datasets(test, mode="MAP"), want, rtol=1e-5)
    np.testing.assert_allclose(port.eval(*test[1], mode="MAP"),
                               jax_model.eval(*test[1], mode="MAP"), rtol=1e-5)
    # without keyword arguments the batched path runs, and the modes differ
    assert not np.allclose(port.eval_datasets(test), want, rtol=1e-3)


def test_confidence_intervals_take_predict_keywords():
    jax_model, port, test = _pair()
    ctx_x, ctx_y, _, _ = test[0]
    x = np.linspace(-5.0, 5.0, 30)
    ucb, lcb = port.confidence_intervals(ctx_x, ctx_y, x, confidence=0.8, mode="MAP")
    ucb_j, lcb_j = jax_model.confidence_intervals(ctx_x, ctx_y, x, confidence=0.8, mode="MAP")
    assert ucb.shape == lcb.shape == (30,) and np.all(ucb > lcb)
    np.testing.assert_allclose(ucb, ucb_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lcb, lcb_j, rtol=1e-5, atol=1e-6)
