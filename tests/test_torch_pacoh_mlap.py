"""The port's PACOH-MLAP learner against the JAX learner.

The JAX learner runs on the CPU as the JAX package's own tests run it (its
XLA general step and meta-test; with the Pallas kernels forced for the
gate, ``PACOH_TPU_FORCE_PALLAS=1``). The port runs on the CPU
(``device="cpu"``), where the fused kernel's wrapper takes its plain
version. Both start from one state (the port loads the JAX learner's
``state_dict()`` through ``from_jax_mlap_state``), and the port is fed the
JAX learner's own task draws and noise, so the same numbers go in.

The states come from chip_smoke.py's ``conditioned_tasks`` and
``conditioned_params``: there the inner KL's gram is well conditioned,
so two float32 orders of the same step agree to rounding (at a learner's
initial state the gram is singular to float32 and they part at the percent
level). Parameter comparisons leave out the kernel net's output bias: its
true score is exactly zero, so its Adam steps follow float noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_learning_pacoh_tpu import GPRegressionMetaLearnedPAC as JaxPAC
from meta_learning_pacoh_tpu.ops.pallas import launch_sched as jax_sched
from meta_learning_pacoh_tpu.utils import jit_cache
from meta_learning_pacoh_torch import GPRegressionMetaLearnedPAC
from meta_learning_pacoh_torch.interop import from_jax_mlap_state
from meta_learning_pacoh_torch.models.random_gp import posterior_rsample
from meta_learning_pacoh_torch.ops import launch_sched
from chip_smoke import conditioned_tasks
from test_torch_fused_mlap import conditioned_params

KW = dict(random_seed=1, covar_module="NN", mean_module="NN", svi_batch_size=3,
          meta_kl_weight=1e-3, mean_nn_layers=(8, 8), kernel_nn_layers=(8, 8))


@pytest.fixture(autouse=True)
def jax_general_step(monkeypatch):
    """The JAX learner's XLA step; the shared() jit cache keys ignore the
    environment, so it is cleared around every test."""
    for name in ("PACOH_TPU_FORCE_PALLAS", "PACOH_TPU_DISABLE_FUSED", "PACOH_TORCH_DISABLE_FUSED",
                 "PACOH_TORCH_DISABLE_KERNELS"):
        monkeypatch.delenv(name, raising=False)
    jit_cache.clear()
    yield
    jit_cache.clear()


def _tasks(ragged=False, seed=2, n_tasks=6):
    rs = np.random.RandomState(seed)
    sizes = (5, 3, 5, 4, 5, 2)[:n_tasks] if ragged else None
    return conditioned_tasks(rs, n_tasks, 5, sizes=sizes), rs


def _pair(ragged=False, **kw):
    """A JAX learner at a conditioned state and the port's from its state."""
    tasks, rs = _tasks(ragged)
    jax_model = JaxPAC(tasks, **dict(KW, **kw))
    jax_model.params = jax.tree.map(jnp.asarray, conditioned_params(jax_model, rs))
    port = GPRegressionMetaLearnedPAC(tasks, device="cpu", **dict(KW, **kw))
    port.load_state_dict(jax_model.state_dict())
    return jax_model, port, rs


def _jax_draws(jax_model, n_steps):
    """The JAX learner's task indices [n_steps, B] and noise [n_steps, S, P]
    of steps 0 .. n_steps - 1 (fold_in, split, randint / normal)."""
    p = jax_model.hyper_prior.dim

    def one(i):
        k_task, k_theta = jax.random.split(jax.random.fold_in(jax_model._train_key, i))
        return (jax.random.randint(k_task, (jax_model.task_batch_size,), 0, jax_model.n_tasks),
                jax.random.normal(k_theta, (jax_model.svi_batch_size, p), jnp.float32))

    idx, eps = jax.vmap(one)(jnp.arange(n_steps))
    return torch.from_numpy(np.asarray(idx).astype(np.int64)), torch.from_numpy(np.array(eps))


def _feed(port, jax_model, n_steps):
    idx, eps = _jax_draws(jax_model, n_steps)
    port._task_draw = lambda step: idx[step]
    port._draw_eps = lambda step, out: out.copy_(eps[step])


def _flat(params):
    return {"loc": np.asarray(params["hyper_post"]["loc"]),
            "log_scale": np.asarray(params["hyper_post"]["log_scale"]),
            **{k: np.asarray(params[k]) for k in ("raw_noise", "q_means", "q_trils")}}


def _assert_params_close(port, jax_model, atol, mean_atol):
    keep = np.ones(port.hyper_prior.dim, bool)
    keep[port.hyper_prior.slice_of(("kernel_nn", "b_out"))] = False
    want = _flat(jax_model.params)
    for k, w in want.items():
        got = port.params[k].numpy()
        if k in ("loc", "log_scale"):
            got, w = got[keep], w[keep]
        d = np.abs(got - w)
        assert d.max() <= atol and d.mean() <= mean_atol, (k, d.max(), d.mean())


def test_carried_state_gives_the_same_loss():
    """From the JAX state, the port's loss of one step with the JAX draws
    equals the JAX learner's (its tasks gathered, the port's count-weighted:
    the same estimator), rtol 1e-5."""
    jax_model, port, _ = _pair(ragged=True)
    state = from_jax_mlap_state(jax_model.state_dict())
    assert set(state["params"]) == {"hyper_post", "raw_noise", "q_means", "q_trils"}
    assert state["opt_state"]["count"] == 0
    idx, eps = _jax_draws(jax_model, 1)
    m = jax_model
    X, Y, M = (jnp.asarray(a) for a in (m.X, m.Y, m.mask))
    post = m.params["hyper_post"]
    theta = post["loc"][None] + jnp.exp(post["log_scale"])[None] * jnp.asarray(eps[0].numpy())
    from meta_learning_pacoh_tpu.models.random_gp import posterior_kl_to_prior

    kl_outer = m.meta_kl_weight * posterior_kl_to_prior(post, m.hyper_prior)
    nv = m._noise_var(m.params["raw_noise"])
    bounds = [m._task_bound(m.params["q_means"][i], m.params["q_trils"][i], X[i], Y[i], theta,
                            nv, kl_outer, float(m.n_tasks), mask=M[i])[0]
              for i in np.asarray(idx[0])]
    meta_c = jnp.sqrt((kl_outer + np.log(2.0) + np.log(6.0) - np.log(m.delta)) / 10.0)
    want = float(jnp.mean(jnp.stack(bounds)) + meta_c)
    counts = torch.bincount(idx[0], minlength=6).float()
    got, diag = port._loss(port.params, eps[0], counts, port.X, port.Y, port.mask)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    assert set(diag) == {"avg_ll", "kl_outer_weighted", "kl_inner_weighted"}


# name -> constructor keywords beyond KW
GENERAL_CASES = {
    "full_batch": dict(),
    "sampled": dict(task_batch_size=3),
    "ragged": dict(ragged=True),
    "staircase_two_groups": dict(lr_decay=0.5, posterior_lr_multiplier=2.0),
    "sgd": dict(optimizer="SGD", lr=1e-2),
}


@pytest.mark.parametrize("case", sorted(GENERAL_CASES))
def test_general_steps_match_jax_trajectory(monkeypatch, case):
    """20 JAX steps and 20 port general steps from one state, the port fed
    the JAX draws: parameters within 1e-4 (a tenth of one step's reach at lr
    1e-3), mean 2e-6, the last loss and diagnostics rtol 1e-4; the steps and
    Adam count carried across (staircase: 5-step transitions in both)."""
    monkeypatch.setattr(launch_sched, "LR_TRANSITION_STEPS", 5)
    monkeypatch.setattr(jax_sched, "LR_TRANSITION_STEPS", 5)
    monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")
    kw = dict(GENERAL_CASES[case])
    jax_model, port, _ = _pair(ragged=kw.pop("ragged", False), **kw)
    assert not port._fused_path_ok()
    _feed(port, jax_model, 20)
    want_loss, want_diag = jax_model.meta_fit(n_iter=20, log_period=20, verbose=False)
    got_loss, got_diag = port.meta_fit(n_iter=20, log_period=10, verbose=False)
    _assert_params_close(port, jax_model, 1e-4, 2e-6)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    for k, v in want_diag.items():
        np.testing.assert_allclose(got_diag[k], v, rtol=1e-4, err_msg=k)
    state = port.state_dict()
    assert state["step"] == 20 and state["opt_state"]["count"] == (
        0 if kw.get("optimizer") == "SGD" else 20)


def test_fused_path_plain_version_matches_jax_trajectory():
    """The fused path's plain version (the closed form, count pages of the
    JAX draws) against 20 JAX general steps from one state."""
    jax_model, port, _ = _pair(task_batch_size=3)
    assert port._fused_path_ok()
    _feed(port, jax_model, 20)
    want_loss, _ = jax_model.meta_fit(n_iter=20, log_period=20, verbose=False)
    got_loss, _ = port.meta_fit(n_iter=20, log_period=20, verbose=False)
    assert port._fused is not None
    _assert_params_close(port, jax_model, 1e-4, 2e-6)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)


def test_init_task_posteriors_match_jax():
    """q at the aggregated prior of the JAX learner's 20 samples and noise."""
    tasks, _ = _tasks(ragged=True)
    jax_model = JaxPAC(tasks, **KW)
    port = GPRegressionMetaLearnedPAC(tasks, device="cpu", **KW)
    port.load_state_dict(jax_model.state_dict())
    key = jax.random.PRNGKey(5)
    want_m, want_t = (np.asarray(a) for a in jax_model._init_task_posteriors(
        jax_model.params["hyper_post"], jax_model.X, key, mask=jnp.asarray(jax_model.mask)))
    k_theta, k_eps = jax.random.split(key)
    theta_eps = np.array(jax.random.normal(k_theta, (20, port.hyper_prior.dim), jnp.float32))
    eps = np.array(jax.random.normal(k_eps, port.X.shape[:2], jnp.float32))
    post = {k: port.params[k] for k in ("loc", "log_scale")}
    got_m, got_t = port._init_q(posterior_rsample(post, torch.from_numpy(theta_eps)),
                                torch.from_numpy(eps), port.X, port.mask)
    np.testing.assert_allclose(got_m.numpy(), want_m, rtol=0, atol=1e-5 * np.abs(want_m).max())
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=0, atol=1e-4 * np.abs(want_t).max())


def _test_tuples(rs, n_tasks=3, ragged=False):
    sizes = (5, 3, 4) if ragged else None
    ctx = conditioned_tasks(rs, n_tasks, 5, sizes=sizes)
    out = []
    for cx, cy in ctx:
        tx = np.linspace(-3.0, 3.0, 9)[:, None] + rs.uniform(-0.3, 0.3, (9, 1))
        out.append((cx, cy, tx, np.sin(tx[:, 0])))
    return out


@pytest.mark.parametrize("path", ["fused", "general"])
@pytest.mark.parametrize("ragged", [False, True])
def test_eval_matches_jax_with_fed_meta_test(monkeypatch, path, ragged):
    """eval_datasets after a 20-step meta-test, the port fed the JAX
    learner's draws (its aggregated prior's samples, the posteriors' start
    and the meta-test's noise): the fused meta-test's plain version or the
    general loop against the JAX XLA meta-test, LL, RMSE and calibration
    rtol 1e-4; a ragged context set padded and masked in both."""
    if path == "general":
        monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")
    jax_model, port, rs = _pair()
    test = _test_tuples(rs, ragged=ragged)
    key = jax.random.PRNGKey(7)
    k_init, k_opt, k_theta = jax.random.split(key, 3)
    k_ith, k_ieps = jax.random.split(k_init)
    p, s, n_iter = port.hyper_prior.dim, port.svi_batch_size, 20

    def normal(k, shape):
        return torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))

    agg, init_theta = normal(k_theta, (20, p)), normal(k_ith, (20, p))
    init_eps = normal(k_ieps, (3, 5))
    steps = torch.stack([normal(k, (s, p)) for k in jax.random.split(k_opt, n_iter)])
    monkeypatch.setattr(jax_model, "_next_key", lambda: key)
    monkeypatch.setattr(port, "_agg_eps", lambda seed: agg)
    monkeypatch.setattr(port, "_init_task_posteriors", lambda post, X, mask, seed: port._init_q(
        posterior_rsample(post, init_theta), init_eps[:, :X.shape[1]], X, mask))
    monkeypatch.setattr(port, "_meta_test_eps", lambda seed, s0, n: steps[s0:s0 + n])
    want = jax_model.eval_datasets(test, n_iter_meta_test=n_iter)
    got = port.eval_datasets(test, n_iter_meta_test=n_iter)
    np.testing.assert_allclose(got, want, rtol=1e-4)


GATE_CASES = {
    "in_window": dict(),
    "lr_decay": dict(lr_decay=0.5),
    "sampled": dict(task_batch_size=3),
    "ragged": dict(ragged=True),
    "se_covar": dict(covar_module="SE"),
    "constant_mean": dict(mean_module="constant"),
    "full_cov": dict(cov_type="full"),
    "feature_dim_2": dict(feature_dim=2),
    "unequal_widths": dict(kernel_nn_layers=(8, 4)),
    "two_widths": dict(mean_nn_layers=(8, 4), kernel_nn_layers=(8, 4)),
    "sh_over_1024": dict(svi_batch_size=33, mean_nn_layers=(32,), kernel_nn_layers=(32,)),
    "n9": dict(n_samples=9),
    "sgd": dict(optimizer="SGD"),
    # the mlap learner (S=5, nets 32x32) at more tasks: the JAX learner's gate
    # has no task bound
    **{f"tasks_{t}_32x32": dict(n_tasks=t, svi_batch_size=5, mean_nn_layers=(32, 32),
                                kernel_nn_layers=(32, 32)) for t in (60, 160)},
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_learner_gate_matches_jax(monkeypatch, case):
    """The port's fused window (training and meta-test) and its fused path
    are the JAX learner's (Pallas forced) on in- and out-of-window configs."""
    monkeypatch.setenv("PACOH_TPU_FORCE_PALLAS", "1")
    kw = dict(KW, **GATE_CASES[case])
    n = kw.pop("n_samples", 5)
    rs = np.random.RandomState(1)
    sizes = (5, 3, 5, 4, 5, 2) if kw.pop("ragged", False) else None
    tasks = conditioned_tasks(rs, kw.pop("n_tasks", 6), n, sizes=sizes)
    jax_model = JaxPAC(tasks, **kw)
    port = GPRegressionMetaLearnedPAC(tasks, device="cpu", **kw)
    for points in (5, 8, 9):
        assert port._fused_window_ok(points) == jax_model._fused_window_ok(points)
    want = jax_model._fused_path_ok()
    assert port._fused_path_ok() == want
    assert want == (case in ("in_window", "lr_decay", "sampled", "ragged")
                    or case.startswith("tasks_"))


@pytest.mark.parametrize("n_tasks", [20, 200])
def test_meta_test_gate_matches_jax(monkeypatch, n_tasks):
    """The port's meta-test takes the kernel's meta-test mode where the JAX
    learner takes its Pallas meta-test (its ``_fused_window_ok`` of the
    context sets' points, pacoh_mlap.py:622), at the MLAP CLI's 200 test
    tasks of 5 points as at 20: the mlap learner (S=5, nets 32x32)."""
    monkeypatch.setenv("PACOH_TPU_FORCE_PALLAS", "1")
    kw = dict(KW, svi_batch_size=5, mean_nn_layers=(32, 32), kernel_nn_layers=(32, 32))
    tasks = conditioned_tasks(np.random.RandomState(1), 6, 5)
    jax_model = JaxPAC(tasks, **kw)
    port = GPRegressionMetaLearnedPAC(tasks, device="cpu", **kw)
    assert jax_model._fused_window_ok(5)
    assert port._fused_meta_test_ok(n_tasks, 5, 1) == jax_model._fused_window_ok(5)


def test_state_dict_round_trip_and_chunkings(monkeypatch):
    """A state_dict round trip mid-fit and two chunkings give the same bits,
    on the fused path's plain version and on the general step."""
    tasks, _ = _tasks()
    for fused in ("0", "1"):
        monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", fused)
        one = GPRegressionMetaLearnedPAC(tasks, device="cpu", **KW)
        one.meta_fit(n_iter=6, log_period=6, verbose=False)
        two = GPRegressionMetaLearnedPAC(tasks, device="cpu", **KW)
        two.meta_fit(n_iter=4, log_period=2, verbose=False)
        three = GPRegressionMetaLearnedPAC(tasks, device="cpu", **KW)
        three.load_state_dict(two.state_dict())
        three.meta_fit(n_iter=2, log_period=2, verbose=False)
        for k in one.params:
            assert torch.equal(one.params[k], three.params[k]), (fused, k)
            assert torch.equal(one._mu[k], three._mu[k]) and torch.equal(one._nu[k], three._nu[k])
        assert three.state_dict()["step"] == 6


def test_predict_and_eval_surface():
    """predict, eval, eval_datasets and confidence_intervals take the
    meta-test's step count (through the base class's keyword arguments for
    eval and confidence_intervals); prior_mean; ragged test sets one by one."""
    _, port, rs = _pair()
    test = _test_tuples(rs)
    cx, cy, tx, ty = test[0]
    mean, std = port.predict(cx, cy, tx, n_iter_meta_test=5)
    assert mean.shape == std.shape == (9,) and np.all(std > 0)
    ll, rmse, calib = port.eval(cx, cy, tx, ty, n_iter_meta_test=5)
    assert np.isfinite([ll, rmse, calib]).all()
    ucb, lcb = port.confidence_intervals(cx, cy, tx, n_iter_meta_test=5)
    assert ucb.shape == lcb.shape == (9,) and np.all(ucb > lcb)
    ragged = [test[0], (test[1][0], test[1][1], test[1][2][:4], test[1][3][:4])]
    assert np.isfinite(port.eval_datasets(ragged, n_iter_meta_test=5)).all()
    assert port.prior_mean(np.linspace(-2.0, 2.0, 4)).shape == (4,)


def test_learner_defaults_to_the_card(monkeypatch):
    """Built without a device, the learner lives on the card; with no card it
    raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tasks, _ = _tasks()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPRegressionMetaLearnedPAC(tasks, **KW)
    assert GPRegressionMetaLearnedPAC(tasks, device="cpu", **KW).device.type == "cpu"
