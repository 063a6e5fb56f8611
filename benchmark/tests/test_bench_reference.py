"""The reference agrees with the program on the CPU at small sizes: PACOH-SVGD's
first steps against the program's general step, and PACOH-MLAP's loss and
gradients against the program's closed form in float64 at a well-conditioned
state."""

import math

import numpy as np
import pytest
import torch

from benchmark import envs, harness
from benchmark.drivers.fit import Driver as FitDriver
from benchmark.reference import gp, mlap


@pytest.mark.parametrize("cell, traffic", [
    ("svgd_sin320_fit", {"n_tasks": 6}),
    ("svgd_cauchy20_fit", {"n_tasks": 3, "n_samples": 12}),
])
@pytest.mark.parametrize("fused", [True, False])
def test_svgd_first_steps_match_the_program(cell, traffic, fused, monkeypatch):
    if not fused:
        monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")  # the general step
    ov = {"config": {"kwargs": {"num_iter_fit": 3}}, "traffic": traffic}
    driver = FitDriver(harness.Cell(cell, overrides=ov), 2 ** 31 + 5, "cpu")
    driver.setup(0)
    readings = driver.readings(driver.got, driver.reference())
    # Adam divides by |g| + 1e-8, so a leaf whose gradient is near 1e-8 moves by
    # what float32 rounding of g sets: the change is held more loosely
    assert readings["grad_gap"] < 1e-4 and readings["change_gap"] < 1e-2, readings


def conditioned(seed, t=4, n=5):
    """A state and tasks at which every prior covariance is far from singular."""
    rng = np.random.RandomState(seed)
    spec = mlap.Spec({"meta_kl_weight": 1e-3}, 1)
    loc, scale = gp.hyper_prior(spec.lay, spec.p, spec.wps, spec.bps, "cpu")
    x = np.linspace(-4, 4, n)[None, :, None] + 0.1 * rng.randn(t, n, 1)
    y = np.sin(x[..., 0]) + 0.1 * rng.randn(t, n)
    low = np.tril(0.3 * rng.randn(t, n, n), -1) + np.eye(n) * (0.5 + rng.rand(t, n, 1))
    state = {"loc": loc + scale * torch.tensor(rng.randn(spec.p)),
             "log_scale": torch.full((spec.p,), math.log(0.01), dtype=torch.float64),
             "raw_noise": torch.tensor(-1.0, dtype=torch.float64),
             "q_means": torch.tensor(y + 0.05 * rng.randn(t, n)), "q_trils": torch.tensor(low)}
    eps = torch.tensor(rng.randn(spec.s, spec.p))
    return spec, state, eps, torch.tensor(x), torch.tensor(y), loc, scale


@pytest.mark.parametrize("meta_test", [False, True])
def test_mlap_loss_and_gradients_match_the_closed_form(meta_test):
    from meta_learning_pacoh_torch.ops.cuda.fused_mlap_kernel import (
        _prior_on,
        mlap_loss_and_grads,
    )

    spec, state, eps, X, Y, loc, scale = conditioned(3)
    counts = torch.tensor([2.0, 0.0, 1.0, 1.0], dtype=torch.float64)
    hp = _prior_on(1, spec.hidden, spec.wps, spec.bps, torch.device("cpu"))
    mask = torch.ones_like(Y)
    want, grads, _ = mlap_loss_and_grads(
        dict(state), eps, None if meta_test else counts, X, Y, mask, hp,
        task_kl_weight=1.0, meta_kl_weight=1e-3, delta=0.1, n_tasks=4, meta_test=meta_test)
    leaf = {k: v.clone().requires_grad_(True) for k, v in state.items()}
    if meta_test:
        klo = mlap.kl_outer(spec, leaf["loc"], leaf["log_scale"], loc, scale)
        prior = mlap.prior_factors(spec, leaf["loc"] + torch.exp(leaf["log_scale"]) * eps, X)
        got = mlap.task_bounds(spec, leaf["q_means"], leaf["q_trils"], Y, prior,
                               mlap.noise_var(leaf["raw_noise"]), klo, 4).sum()
        keys = ("q_means", "q_trils")
    else:
        got = mlap.fit_loss(spec, leaf, eps, counts, X, Y, loc, scale)
        keys = mlap.STATE
    ref = torch.autograd.grad(got, [leaf[k] for k in keys])
    assert float(got) == pytest.approx(float(want), rel=1e-10)
    for k, g in zip(keys, ref):
        assert float((g - grads[k]).abs().max()) <= 1e-8 * float(g.abs().max()), k


def test_the_environments_draw_what_the_program_s_environments_draw():
    from meta_learning_pacoh_torch.datasets import data_sim

    ours = envs.environment("sinusoid", 41).meta_train(3, 5)
    theirs = data_sim.SinusoidDataset(random_state=np.random.RandomState(42)) \
        .generate_meta_train_data(3, 5)
    for (a, b), (c, d) in zip(ours, theirs):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    ours = envs.environment("cauchy", 41).meta_test(2, 4, 6)
    theirs = data_sim.CauchyDataset(random_state=np.random.RandomState(42)) \
        .generate_meta_test_data(2, 4, 6)
    for a, b in zip(ours, theirs):
        assert all(np.array_equal(u, v) for u, v in zip(a, b))
