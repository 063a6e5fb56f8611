"""The port's PACOH-MAP learner against the JAX learner.

The JAX learner runs on the CPU as the JAX package's own tests run it: its
XLA general step, a sampled task batch gathered (its CPU default) or weighted
by draw counts (``PACOH_TPU_MAP_WEIGHTED=1``, the port's only mode). The port
runs on the CPU (``device="cpu"``), where the fused training kernel's
wrapper takes its plain version. Both start from the JAX learner's state
(``load_state_dict`` of its ``state_dict()``), so the same numbers go in.

Parameter comparisons leave out the kernel net's output bias: its true
gradient is exactly zero, so both sides random-walk float noise there.
"""

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from meta_learning_pacoh_tpu import GPRegressionMetaLearned as JaxMAP
from meta_learning_pacoh_tpu import GPRegressionMetaLearnedSVGD as JaxSVGD
from meta_learning_pacoh_tpu.ops.pallas import launch_sched as jax_sched
from meta_learning_pacoh_tpu.utils import jit_cache
from meta_learning_pacoh_torch import (
    GPRegressionLearned,
    GPRegressionLearnedPAC,
    GPRegressionMetaLearned,
    GPRegressionMetaLearnedSVGD,
    MAMLRegression,
    NPRegressionMetaLearned,
)
from meta_learning_pacoh_torch.datasets import SinusoidDataset
from meta_learning_pacoh_torch.interop import from_jax_map_state, params_from_jax
from meta_learning_pacoh_torch.models.random_gp import layout_slice
from meta_learning_pacoh_torch.ops import launch_sched

KW = dict(mean_nn_layers=(8, 8), kernel_nn_layers=(8, 8), weight_decay=0.2, random_seed=30)


@pytest.fixture(autouse=True)
def jax_general_step(monkeypatch):
    """The JAX learner's XLA general step; the shared() jit cache keys ignore
    the environment, so it is cleared around every test."""
    for name in ("PACOH_TPU_FORCE_PALLAS", "PACOH_TPU_MAP_WEIGHTED", "PACOH_TORCH_DISABLE_FUSED"):
        monkeypatch.delenv(name, raising=False)
    jit_cache.clear()
    yield
    jit_cache.clear()


def _sin(n_tasks=6, n_samples=5, ragged=True):
    """Sinusoid tasks (the demo's environment); one task shorter, so padded."""
    env = SinusoidDataset(random_state=np.random.RandomState(26))
    train = env.generate_meta_train_data(n_tasks=n_tasks, n_samples=n_samples)
    if ragged:
        train[1] = (train[1][0][:3], train[1][1][:3])
    test = env.generate_meta_test_data(n_tasks=3, n_samples_context=5, n_samples_test=20)
    return train, test


def _pair(train, **kw):
    """A JAX learner and the port's learner started from its state."""
    kw = dict(KW, **kw)
    jax_model = JaxMAP(train, **kw)
    port = GPRegressionMetaLearned(train, device="cpu", **kw)
    port.load_state_dict(jax_model.state_dict())
    return jax_model, port


def _keep(port):
    keep = np.ones(port.params.numel(), bool)
    if port.cfg.covar_module == "NN":
        keep[layout_slice(port.layout, ("kernel_nn", "b_out"))] = False
    return keep


def _params(model):
    return params_from_jax(model.params) if isinstance(model, JaxMAP) else model.params.numpy()


def _jax_draws(jax_model, n_steps):
    """The JAX learner's task indices of steps 0 .. n_steps - 1 (fold_in, randint)."""
    keys = jax.vmap(lambda i: jax.random.fold_in(jax_model._train_key, i))(np.arange(n_steps))
    draw = jax.vmap(lambda k: jax.random.randint(k, (jax_model.task_batch_size,), 0,
                                                 jax_model.n_tasks))
    return np.asarray(draw(keys)).astype(np.int64)


def test_data_and_state_match_jax():
    """Padded tasks equal to the byte; the flat parameters in the JAX
    ravel order (P = 2343 at the demo's widths); a fresh AdamW state."""
    train, _ = _sin()
    jax_model, port = _pair(train, mean_nn_layers=(32, 32), kernel_nn_layers=(32, 32))
    for got, want in ((port.X, jax_model.X), (port.Y, jax_model.Y),
                      (port.mask, jax_model.mask)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert port.params.numel() == 2343
    np.testing.assert_array_equal(port.params.numpy(),
                                  ravel_pytree(jax_model.params)[0])
    state = from_jax_map_state(jax_model.state_dict())
    assert state["opt_state"]["count"] == 0 and not state["opt_state"]["mu"].any()


def test_predictions_match_jax_from_same_state():
    """From the JAX state after 4 steps (non-zero AdamW moments): predictions
    rtol 1e-5 (one float32 GP posterior each), eval metrics rtol 1e-5, and
    the moments carried across exactly."""
    train, test = _sin()
    jax_model = JaxMAP(train, task_batch_size=-1, **KW)
    jax_model.meta_fit(n_iter=4, log_period=4, verbose=False)
    port = GPRegressionMetaLearned(train, device="cpu", task_batch_size=-1, **KW)
    port.load_state_dict(jax_model.state_dict())
    adam = jax_model.opt_state.inner_states["train"].inner_state[0]
    np.testing.assert_array_equal(port._mu.numpy(), params_from_jax(adam.mu))
    assert port._adam_count == 4 and port._step_count == 4
    for ctx_x, ctx_y, test_x, _ in test:
        mean, std = port.predict(ctx_x, ctx_y, test_x)
        mean_j, std_j = jax_model.predict(ctx_x, ctx_y, test_x)
        np.testing.assert_allclose(mean, mean_j, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(std, std_j, rtol=1e-5)
    np.testing.assert_allclose(port.eval_datasets(test), jax_model.eval_datasets(test),
                               rtol=1e-5, atol=1e-6)


def _sampled_steps_match_jax(jax_mode, port_path, monkeypatch):
    """Five sampled-batch steps (batch 3 of 6 tasks) of the JAX learner in
    ``jax_mode`` and of the port (count-weighted) through ``port_path``, the
    port drawing the JAX learner's own task indices."""
    monkeypatch.setenv("PACOH_TPU_MAP_WEIGHTED", "1" if jax_mode == "counted" else "0")
    if port_path == "general":
        monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")
    train, _ = _sin()
    jax_model, port = _pair(train, task_batch_size=3)
    assert jax_model._weight_by_counts() == (jax_mode == "counted")
    assert port._fused_path_ok() == (port_path == "fused")
    idx = torch.from_numpy(_jax_draws(jax_model, 5))
    port._task_draw = lambda step: idx[step]
    want_loss = jax_model.meta_fit(n_iter=5, log_period=5, verbose=False)
    got_loss = port.meta_fit(n_iter=5, log_period=5, verbose=False)
    keep = _keep(port)
    np.testing.assert_allclose(_params(port)[keep], _params(jax_model)[keep], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert port.state_dict()["step"] == jax_model.state_dict()["step"] == 5


def test_general_steps_in_gather_mode_match_jax(monkeypatch):
    """The port's count-weighted general step against the JAX learner's
    gather mode (its CPU default) on the same draws, the same estimator in
    another float association: parameters atol 1e-5 (a hundredth of one
    step's reach at lr 1e-3), the last loss rtol 1e-5."""
    _sampled_steps_match_jax("gather", "general", monkeypatch)


@pytest.mark.parametrize("port_path", ["general", "fused"])
def test_sampled_steps_match_jax_counted_mode(monkeypatch, port_path):
    """The port's count-weighted steps (general step, or the fused kernel's
    plain version) against the JAX learner's counted mode on the same draws:
    parameters atol 1e-5, the last loss rtol 1e-5."""
    _sampled_steps_match_jax("counted", port_path, monkeypatch)


def _losses(model, n_steps):
    return np.array([model.meta_fit(n_iter=1, log_period=1, verbose=False)
                     for _ in range(n_steps)])


@pytest.mark.parametrize("path", ["fused", "general"])
def test_full_batch_loss_trajectory_matches_jax(monkeypatch, path):
    """The demo's configuration at full batch (20 tasks of 5 points, both
    nets (32, 32)) from the JAX learner's initial parameters: 100 steps'
    losses within 1e-5 relative over the first 10 steps and 1e-4 over all
    100 (float32 rounding, amplified by Adam's normalisation, grows with the
    steps), through the fused kernel's plain version or the general step."""
    if path == "general":
        monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")
    env = SinusoidDataset(random_state=np.random.RandomState(26))
    train = env.generate_meta_train_data(n_tasks=20, n_samples=5)
    jax_model, port = _pair(train, task_batch_size=-1, mean_nn_layers=(32, 32),
                            kernel_nn_layers=(32, 32))
    assert port._fused_path_ok() == (path == "fused")
    got, want = _losses(port, 100), _losses(jax_model, 100)
    gap = np.abs(got - want) / np.abs(want)
    assert gap[:10].max() < 1e-5 and gap.max() < 1e-4, gap.max()
    assert want[-1] < want[0] - 1.0  # the fit made progress


# name -> constructor keywords beyond KW
MODE_CASES = {
    "learn_mean_se": dict(learning_mode="learn_mean", covar_module="SE"),
    "learn_kernel_constant": dict(learning_mode="learn_kernel", mean_module="constant",
                                  kernel_nn_layers=(8,)),
    "vanilla": dict(learning_mode="vanilla", covar_module="SE", mean_module="constant"),
    "sgd": dict(optimizer="SGD", lr_params=1e-2),
    "lr_decay": dict(lr_decay=0.5),
}


@pytest.mark.parametrize("case", sorted(MODE_CASES))
def test_modes_and_optimizers_match_jax(monkeypatch, case):
    """Eight full-batch general steps for each learning_mode, SGD, and a
    staircase lr (transition shrunk to 3 in both packages), from the JAX
    initial state moved by 0.3 (so no leaf starts at 0): parameters atol
    1e-5; a frozen leaf keeps its bits (no update, no weight decay)."""
    monkeypatch.setattr(launch_sched, "LR_TRANSITION_STEPS", 3)
    monkeypatch.setattr(jax_sched, "LR_TRANSITION_STEPS", 3)
    train, _ = _sin()
    jax_model, port = _pair(train, task_batch_size=-1, **MODE_CASES[case])
    state = jax_model.state_dict()
    state["params"] = jax.tree.map(lambda a: a + np.float32(0.3), state["params"])
    jax_model.load_state_dict(state)
    port.load_state_dict(state)
    start = port.params.clone()
    jax_model.meta_fit(n_iter=8, log_period=8, verbose=False)
    port.meta_fit(n_iter=8, log_period=8, verbose=False)
    keep = _keep(port)
    np.testing.assert_allclose(_params(port)[keep], _params(jax_model)[keep], rtol=0, atol=1e-5)
    frozen = port._train_mask == 0
    assert torch.equal(port.params[frozen], start[frozen])
    assert bool(frozen.any()) == (case in ("learn_mean_se", "learn_kernel_constant", "vanilla"))
    moved = (port.params - start).abs()[~frozen]
    assert float(moved.max()) > 1e-3


@pytest.mark.parametrize("task_batch_size", [-1, 3])
def test_fused_path_matches_general_step(monkeypatch, task_batch_size):
    """On the CPU, the fused kernel's plain version and the general step
    (full batch, or count-weighted batches of 3 with the same draws) give the
    same bits after 10 steps: the same autograd loss and the same AdamW
    (``cuda.adam_step_``)."""
    train, _ = _sin()
    kw = dict(KW, task_batch_size=task_batch_size)
    fused = GPRegressionMetaLearned(train, device="cpu", **kw)
    assert fused._fused_path_ok()
    fused_loss = fused.meta_fit(n_iter=10, log_period=10, verbose=False)
    monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")
    general = GPRegressionMetaLearned(train, device="cpu", **kw)
    assert not general._fused_path_ok()
    general_loss = general.meta_fit(n_iter=10, log_period=10, verbose=False)
    assert torch.equal(fused.params, general.params)
    assert torch.equal(fused._mu, general._mu) and torch.equal(fused._nu, general._nu)
    assert fused_loss == general_loss
    assert fused._adam_count == general._adam_count == 10


def test_fused_chunkings_and_resume_are_bit_identical(monkeypatch):
    """Count-weighted batches and a staircase lr (transition 2): one chunk,
    chunks of 2, and a state_dict resume mid-fit through the fused path give
    the same bits."""
    monkeypatch.setattr(launch_sched, "LR_TRANSITION_STEPS", 2)
    train, _ = _sin()
    kw = dict(KW, task_batch_size=3, lr_decay=0.5)
    one = GPRegressionMetaLearned(train, device="cpu", **kw)
    one.meta_fit(n_iter=7, log_period=7, verbose=False)
    chunked = GPRegressionMetaLearned(train, device="cpu", **kw)
    chunked.meta_fit(n_iter=7, log_period=2, verbose=False)
    resumed = GPRegressionMetaLearned(train, device="cpu", **kw)
    resumed.meta_fit(n_iter=4, verbose=False)
    fresh = GPRegressionMetaLearned(train, device="cpu", **kw)
    fresh.load_state_dict(resumed.state_dict())
    fresh.meta_fit(n_iter=3, verbose=False)
    assert one._fused is not None and fresh._fused is not None
    for other in (chunked, fresh):
        assert torch.equal(one.params, other.params)
        assert torch.equal(one._nu, other._nu)
    assert torch.isfinite(one.params).all()


def _svgd_pair(train):
    kw = dict(num_particles=3, mean_nn_layers=(8, 8), kernel_nn_layers=(8, 8),
              task_batch_size=-1, random_seed=30)
    jax_model = JaxSVGD(train, **kw)
    jax_model.meta_fit(n_iter=3, log_period=3, verbose=False)
    port = GPRegressionMetaLearnedSVGD(train, device="cpu", **kw)
    port.load_state_dict(jax_model.state_dict())
    return jax_model, port


@pytest.mark.parametrize("learner", ["map", "svgd"])
def test_confidence_intervals_match_jax(learner):
    """The 90% interval at 40 points from the same state: rtol 1e-4 (a
    Normal's icdf for MAP; for SVGD, the bisection of the particle mixture's
    cdf to 1e-6, hence also atol 1e-5), upper above lower."""
    train, test = _sin()
    if learner == "map":
        jax_model = JaxMAP(train, task_batch_size=-1, **KW)
        jax_model.meta_fit(n_iter=3, log_period=3, verbose=False)
        port = GPRegressionMetaLearned(train, device="cpu", task_batch_size=-1, **KW)
        port.load_state_dict(jax_model.state_dict())
    else:
        jax_model, port = _svgd_pair(train)
    ctx_x, ctx_y = test[0][0], test[0][1]
    x = np.linspace(-5.0, 5.0, 40)
    ucb, lcb = port.confidence_intervals(ctx_x, ctx_y, x, confidence=0.9)
    ucb_j, lcb_j = jax_model.confidence_intervals(ctx_x, ctx_y, x, confidence=0.9)
    assert ucb.shape == lcb.shape == (40,) and np.all(ucb > lcb)
    np.testing.assert_allclose(ucb, ucb_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lcb, lcb_j, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("learner", [GPRegressionMetaLearned, GPRegressionMetaLearnedSVGD,
                                     GPRegressionLearned, GPRegressionLearnedPAC,
                                     MAMLRegression, NPRegressionMetaLearned])
def test_learners_default_to_the_card(monkeypatch, learner):
    """Built without a device, a learner lives on the card; with no card it
    raises instead of carrying on on the CPU. The single-task learners take
    one task's (x, y); MAML and the NP their own net widths."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train, _ = _sin(ragged=False)
    data = train[0] if learner in (GPRegressionLearned, GPRegressionLearnedPAC) else (train,)
    kw = {MAMLRegression: dict(layer_sizes=(4,)),
          NPRegressionMetaLearned: dict(r_dim=4, z_dim=4, h_dim=4)}.get(
        learner, dict(mean_nn_layers=(4,), kernel_nn_layers=(4,)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        learner(*data, **kw)
    assert learner(*data, device="cpu", **kw).device.type == "cpu"
