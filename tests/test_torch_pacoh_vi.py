"""The port's PACOH-VI learner against the JAX learner.

The JAX learner runs on the CPU as the JAX package's own tests run it: its
XLA general step (a sampled task batch gathered), or, for the gate, with
the Pallas kernels forced and count-weighted batches on
(``PACOH_TPU_FORCE_PALLAS=1``, ``PACOH_TPU_VI_WEIGHTED=1``). The port runs on
the CPU (``device="cpu"``), where the fused training kernel's wrapper takes
its plain version. Both start from the JAX learner's state (``load_state_dict``
of its ``state_dict()``), and the port is fed the JAX learner's own noise
and task draws, so the same numbers go in.

Posterior comparisons leave out the kernel net's output bias: its true
gradient is exactly zero, so its loc and log_scale random-walk float noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_learning_pacoh_tpu import GPRegressionMetaLearnedVI as JaxVI
from meta_learning_pacoh_tpu.ops.pallas import launch_sched as jax_sched
from meta_learning_pacoh_tpu.utils import jit_cache
from meta_learning_pacoh_torch import GPRegressionMetaLearnedVI
from meta_learning_pacoh_torch.datasets import SinusoidDataset
from meta_learning_pacoh_torch.interop import from_jax_vi_state
from meta_learning_pacoh_torch.ops import launch_sched

S = 4
KW = dict(svi_batch_size=S, mean_nn_layers=(8, 8), kernel_nn_layers=(8, 8), random_seed=30)


@pytest.fixture(autouse=True)
def jax_general_step(monkeypatch):
    """The JAX learner's XLA general step; the shared() jit cache keys ignore
    the environment, so it is cleared around every test."""
    for name in ("PACOH_TPU_FORCE_PALLAS", "PACOH_TPU_VI_WEIGHTED", "PACOH_TPU_DISABLE_FUSED",
                 "PACOH_TPU_FORCE_BIGN_FUSED", "PACOH_TORCH_DISABLE_FUSED"):
        monkeypatch.delenv(name, raising=False)
    jit_cache.clear()
    yield
    jit_cache.clear()


def _sin(n_tasks=6, n_samples=5, ragged=True):
    """Sinusoid tasks; with ragged, one task shorter, so padded."""
    env = SinusoidDataset(random_state=np.random.RandomState(26))
    train = env.generate_meta_train_data(n_tasks=n_tasks, n_samples=n_samples)
    if ragged:
        train[1] = (train[1][0][:3], train[1][1][:3])
    test = env.generate_meta_test_data(n_tasks=3, n_samples_context=5, n_samples_test=20)
    return train, test


def _keep(port):
    keep = np.ones(port.hyper_prior.dim, bool)
    keep[port.hyper_prior.slice_of(("kernel_nn", "b_out"))] = False
    return keep


def _jax_draws(jax_model, n_steps):
    """The JAX learner's task indices [n_steps, batch] and noise [n_steps, S, P]
    of steps 0 .. n_steps - 1 (fold_in, split, randint / normal)."""
    p = jax_model.hyper_prior.dim

    def one(i):
        k_task, k_sample = jax.random.split(jax.random.fold_in(jax_model._train_key, i))
        return (jax.random.randint(k_task, (jax_model.task_batch_size,), 0, jax_model.n_tasks),
                jax.random.normal(k_sample, (jax_model.svi_batch_size, p), jnp.float32))

    idx, eps = jax.vmap(one)(jnp.arange(n_steps))
    return torch.from_numpy(np.asarray(idx).astype(np.int64)), torch.from_numpy(np.array(eps))


def _feed(port, jax_model, n_steps):
    """Give the port the JAX learner's draws of steps 0 .. n_steps - 1."""
    idx, eps = _jax_draws(jax_model, n_steps)
    port._task_draw = lambda step: idx[step]
    port._draw_eps = lambda step, out: out.copy_(eps[step])


def _post(model, key):
    return np.asarray(model.posterior[key]) if isinstance(model, JaxVI) else \
        model.posterior[key].numpy()


# name -> constructor keywords beyond KW
GENERAL_CASES = {
    "diag": dict(),
    "full": dict(cov_type="full"),
    "diag_sampled": dict(task_batch_size=3),
    "sgd_staircase": dict(optimizer="SGD", lr=1e-2, lr_decay=0.5),
}


@pytest.mark.parametrize("case", sorted(GENERAL_CASES))
def test_general_steps_match_jax(monkeypatch, case):
    """Three JAX steps, then five steps of each from the JAX state (loaded
    through ``from_jax_vi_state``) with the JAX learner's noise and task
    draws, through the port's general step (the sampled batch
    count-weighted, JAX's gathered: the same estimator; SGD with a
    staircase of 3-step transitions in both packages): the posterior atol
    1e-5 (a hundredth of one step's reach at lr 1e-3), the last loss rtol
    1e-5, the steps and Adam count carried across."""
    monkeypatch.setattr(launch_sched, "LR_TRANSITION_STEPS", 3)
    monkeypatch.setattr(jax_sched, "LR_TRANSITION_STEPS", 3)
    monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")
    train, _ = _sin()
    kw = dict(KW, **GENERAL_CASES[case])
    jax_model = JaxVI(train, **kw)
    jax_model.meta_fit(n_iter=3, log_period=3, verbose=False)
    port = GPRegressionMetaLearnedVI(train, device="cpu", **kw)
    port.load_state_dict(jax_model.state_dict())
    assert not port._fused_path_ok()
    _feed(port, jax_model, 8)
    want_loss = jax_model.meta_fit(n_iter=5, log_period=5, verbose=False)
    got_loss = port.meta_fit(n_iter=5, log_period=5, verbose=False)
    keep = _keep(port)
    for key in port.posterior:
        got, want = _post(port, key), _post(jax_model, key)
        if key != "tril_raw":
            got, want = got[keep], want[keep]
        else:
            got, want = got[np.ix_(keep, keep)], want[np.ix_(keep, keep)]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    state = port.state_dict()
    assert state["step"] == jax_model.state_dict()["step"] == 8
    assert state["opt_state"]["count"] == (0 if kw.get("optimizer") == "SGD" else 8)


def test_state_and_main_configuration():
    """The sin_20 VI configuration: the data equal to the byte, P = 2308, the
    fused path taken; a fresh JAX state carries a zero Adam state across."""
    env = SinusoidDataset(random_state=np.random.RandomState(26))
    train = env.generate_meta_train_data(n_tasks=20, n_samples=5)
    jax_model = JaxVI(train, random_seed=30)
    port = GPRegressionMetaLearnedVI(train, random_seed=30, device="cpu")
    for got, want in ((port.X, jax_model.X), (port.Y, jax_model.Y),
                      (port.mask, jax_model.mask)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert port.hyper_prior.dim == 2308 and port.svi_batch_size == 10
    assert port._fused_path_ok()
    state = from_jax_vi_state(jax_model.state_dict())
    assert set(state["posterior"]) == {"loc", "log_scale"}
    assert state["opt_state"]["count"] == 0 and not state["opt_state"]["mu"]["loc"].any()
    port.load_state_dict(jax_model.state_dict())
    np.testing.assert_array_equal(port.posterior["log_scale"].numpy(),
                                  np.asarray(jax_model.posterior["log_scale"]))


def test_main_configuration_loss_trajectory_matches_jax():
    """The sin_20 configuration at full width (20 tasks, S=10, nets 32x32)
    from the JAX learner's initial posterior and with its noise: 30 steps
    through the fused path's plain version against the JAX general step,
    the losses within rtol 1e-5 and the posterior atol 1e-5."""
    env = SinusoidDataset(random_state=np.random.RandomState(26))
    train = env.generate_meta_train_data(n_tasks=20, n_samples=5)
    jax_model = JaxVI(train, random_seed=30)
    port = GPRegressionMetaLearnedVI(train, random_seed=30, device="cpu")
    port.load_state_dict(jax_model.state_dict())
    _feed(port, jax_model, 30)
    assert port._fused_path_ok()
    want = np.array([jax_model.meta_fit(n_iter=1, log_period=1, verbose=False)
                     for _ in range(30)])
    got = np.array([port.meta_fit(n_iter=1, log_period=1, verbose=False) for _ in range(30)])
    assert port._fused is not None
    np.testing.assert_allclose(got, want, rtol=1e-5)
    keep = _keep(port)
    for key in ("loc", "log_scale"):
        np.testing.assert_allclose(_post(port, key)[keep], _post(jax_model, key)[keep],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("task_batch_size", [-1, 3])
def test_fused_path_matches_general_step(monkeypatch, task_batch_size):
    """On the CPU, the fused kernel's plain version and the general step give
    the same bits after 6 steps (one negative ELBO by autograd, one Adam,
    the same noise and task draws), full batch or count-weighted batches of
    3."""
    train, _ = _sin(ragged=task_batch_size == -1)
    kw = dict(KW, task_batch_size=task_batch_size)
    fused = GPRegressionMetaLearnedVI(train, device="cpu", **kw)
    assert fused._fused_path_ok()
    fused_loss = fused.meta_fit(n_iter=6, log_period=6, verbose=False)
    monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")
    general = GPRegressionMetaLearnedVI(train, device="cpu", **kw)
    assert not general._fused_path_ok()
    general_loss = general.meta_fit(n_iter=6, log_period=6, verbose=False)
    assert fused._fused is not None and general._fused is None
    for tree in ("posterior", "_mu", "_nu"):
        for key in ("loc", "log_scale"):
            assert torch.equal(getattr(fused, tree)[key], getattr(general, tree)[key])
    assert fused_loss == general_loss
    assert fused._adam_count == general._adam_count == 6


def test_fused_chunkings_and_resume_are_bit_identical(monkeypatch):
    """Count-weighted batches and a staircase lr (transition 2): one chunk,
    chunks of 2, general steps then fused ones, and a state_dict resume
    mid-fit give the same bits."""
    monkeypatch.setattr(launch_sched, "LR_TRANSITION_STEPS", 2)
    train, _ = _sin(ragged=False)
    kw = dict(KW, task_batch_size=3, lr_decay=0.5)
    one = GPRegressionMetaLearnedVI(train, device="cpu", **kw)
    one.meta_fit(n_iter=7, log_period=7, verbose=False)
    chunked = GPRegressionMetaLearnedVI(train, device="cpu", **kw)
    chunked.meta_fit(n_iter=7, log_period=2, verbose=False)
    resumed = GPRegressionMetaLearnedVI(train, device="cpu", **kw)
    resumed.meta_fit(n_iter=4, verbose=False)
    fresh = GPRegressionMetaLearnedVI(train, device="cpu", **kw)
    fresh.load_state_dict(resumed.state_dict())
    fresh.meta_fit(n_iter=3, verbose=False)
    mixed = GPRegressionMetaLearnedVI(train, device="cpu", **kw)
    monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")
    mixed.meta_fit(n_iter=3, verbose=False)
    monkeypatch.delenv("PACOH_TORCH_DISABLE_FUSED")
    mixed.meta_fit(n_iter=4, verbose=False)
    assert one._fused is not None and fresh._fused is not None and mixed._fused is not None
    for other in (chunked, fresh, mixed):
        for tree in ("posterior", "_nu"):
            for key in ("loc", "log_scale"):
                assert torch.equal(getattr(one, tree)[key], getattr(other, tree)[key])
    assert torch.isfinite(one.posterior["loc"]).all()


def test_predictions_match_jax_from_same_state(monkeypatch):
    """From the JAX state after 4 steps, with the JAX learner's posterior
    samples fed in: MAP-mode predictions rtol 1e-5; Bayes-mode predictions,
    eval_datasets and the 90% confidence intervals (bisection of the
    mixture's cdf to 1e-6, hence also atol 1e-5) rtol 1e-4."""
    train, test = _sin()
    jax_model = JaxVI(train, **KW)
    jax_model.meta_fit(n_iter=4, log_period=4, verbose=False)
    port = GPRegressionMetaLearnedVI(train, device="cpu", **KW)
    port.load_state_dict(jax_model.state_dict())
    key = jax.random.PRNGKey(11)
    eps = np.asarray(jax.random.normal(key, (100, port.hyper_prior.dim), jnp.float32))
    monkeypatch.setattr(jax_model, "_next_key", lambda: key)
    monkeypatch.setattr(port, "_posterior_eps", lambda n: torch.from_numpy(eps[:n]))
    ctx_x, ctx_y, test_x, _ = test[0]
    for mode, rtol in (("MAP", 1e-5), ("Bayes", 1e-4)):
        mean, std = port.predict(ctx_x, ctx_y, test_x, mode=mode)
        mean_j, std_j = jax_model.predict(ctx_x, ctx_y, test_x, mode=mode)
        np.testing.assert_allclose(mean, mean_j, rtol=rtol, atol=1e-6)
        np.testing.assert_allclose(std, std_j, rtol=rtol)
    np.testing.assert_allclose(port.eval_datasets(test), jax_model.eval_datasets(test),
                               rtol=1e-4, atol=1e-6)
    x = np.linspace(-5.0, 5.0, 40)
    ucb, lcb = port.confidence_intervals(ctx_x, ctx_y, x, confidence=0.9)
    ucb_j, lcb_j = jax_model.confidence_intervals(ctx_x, ctx_y, x, confidence=0.9)
    assert ucb.shape == lcb.shape == (40,) and np.all(ucb > lcb)
    np.testing.assert_allclose(ucb, ucb_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lcb, lcb_j, rtol=1e-4, atol=1e-5)


GATE_CASES = {
    "sin_like": dict(),
    "lr_decay": dict(lr_decay=0.5),
    "ragged_full_batch": dict(ragged=True),
    "counted_uniform": dict(task_batch_size=2),
    "counted_ragged": dict(task_batch_size=2, ragged=True),
    "full_cov": dict(cov_type="full"),
    "sgd": dict(optimizer="SGD"),
    "feature_dim_2": dict(feature_dim=2),
    "se_covar": dict(covar_module="SE"),
    "unequal_widths": dict(kernel_nn_layers=(8, 4)),
    "two_widths": dict(mean_nn_layers=(8, 4), kernel_nn_layers=(8, 4)),
    "n9": dict(n_samples=9),
    "sh_over_1024": dict(svi_batch_size=33, mean_nn_layers=(32,), kernel_nn_layers=(32,)),
    # the sin_20 VI learner at the task counts of baseline_comparison_n_tasks:
    # the JAX learner's gate has no task bound
    **{f"sin_{t}_32x32": dict(n_tasks=t, svi_batch_size=10, mean_nn_layers=(32, 32),
                              kernel_nn_layers=(32, 32)) for t in (60, 160, 320)},
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_learner_gate_matches_jax(monkeypatch, case):
    """The port takes the fused path exactly where the JAX learner does
    (Pallas forced, counted batches on as on the TPU, the JAX learner's
    big-N fused path forced on: the port's H100 policy)."""
    monkeypatch.setenv("PACOH_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("PACOH_TPU_VI_WEIGHTED", "1")
    monkeypatch.setenv("PACOH_TPU_FORCE_BIGN_FUSED", "1")
    kw = dict(KW, **GATE_CASES[case])
    train, _ = _sin(n_tasks=kw.pop("n_tasks", 6), n_samples=kw.pop("n_samples", 5),
                    ragged=kw.pop("ragged", False))
    want = JaxVI(train, **kw)._fused_path_ok()
    assert GPRegressionMetaLearnedVI(train, device="cpu", **kw)._fused_path_ok() == want
    assert want == (case in ("sin_like", "lr_decay", "ragged_full_batch", "counted_uniform",
                             "n9") or case.startswith("sin_"))


def test_gate_follows_the_switches(monkeypatch):
    model = GPRegressionMetaLearnedVI(_sin()[0], device="cpu", **KW)
    assert model._fused_path_ok()
    monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")
    assert not model._fused_path_ok()
    monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "0")
    monkeypatch.setenv("PACOH_TORCH_DISABLE_KERNELS", "1")
    assert not model._fused_path_ok()


def test_learner_defaults_to_the_card(monkeypatch):
    """Built without a device, the learner lives on the card; with no card it
    raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train, _ = _sin(ragged=False)
    kw = dict(mean_nn_layers=(4,), kernel_nn_layers=(4,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPRegressionMetaLearnedVI(train, **kw)
    assert GPRegressionMetaLearnedVI(train, device="cpu", **kw).device.type == "cpu"
