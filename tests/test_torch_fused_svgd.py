"""The port's fused PACOH-SVGD training path against the JAX package's.

On the CPU ``fused_svgd_train`` takes its plain version (autograd of
``meta_log_prob``, ``svgd_phi_ref``, the optax Adam update); the JAX side
runs the Pallas mega-kernel ``fused_svgd_train_packed`` in interpret mode,
as the JAX package's own tests do, on state converted with its
``pack_state`` / ``unpack_state``. Inputs come from numpy seeds at a small
size: K=4 particles, T=4 tasks of N=5 points, D=1, hidden (8, 8).

Particle comparisons leave out the kernel net's output bias: its true
gradient is exactly zero, so both sides random-walk float noise there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from meta_learning_pacoh_tpu import GPRegressionMetaLearnedSVGD as JaxSVGD
from meta_learning_pacoh_tpu.models import random_gp as jax_random_gp
from meta_learning_pacoh_tpu.ops.pallas import launch_sched as jax_sched
from meta_learning_pacoh_tpu.ops.pallas.fused_train_kernel import (
    fused_svgd_train_packed,
    pack_state,
    unpack_state,
)
from meta_learning_pacoh_tpu.utils import jit_cache
from meta_learning_pacoh_torch import GPRegressionMetaLearnedSVGD
from meta_learning_pacoh_torch.datasets import SinusoidDataset
from meta_learning_pacoh_torch.models import random_gp
from meta_learning_pacoh_torch.ops import launch_sched
from meta_learning_pacoh_torch.ops.cuda import fused_svgd_kernel as fk

K, T, N, D = 4, 4, 5, 1
HIDDEN = (8, 8)
WPS, BPS, PF, LR = 0.5, 3.0, 0.01, 1e-3
KW = dict(num_particles=K, mean_nn_layers=HIDDEN, kernel_nn_layers=HIDDEN, random_seed=30)


@pytest.fixture
def jax_fused(monkeypatch):
    """The JAX learner's Pallas kernels in interpret mode, its fused path on
    (counted batches as on the TPU); the shared() jit cache ignores these
    flags, so it is cleared around the test."""
    monkeypatch.setenv("PACOH_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("PACOH_TPU_SVGD_WEIGHTED", "1")
    monkeypatch.delenv("PACOH_TPU_DISABLE_FUSED", raising=False)
    monkeypatch.delenv("PACOH_TPU_FORCE_BIGN_FUSED", raising=False)
    jit_cache.clear()
    yield
    jit_cache.clear()


def _inputs(seed, ragged):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-2.0, 2.0, (T, N, D)).astype(np.float32)
    y = (np.sin(2.0 * x[..., 0]) + 0.1 * rs.randn(T, N)).astype(np.float32)
    mask = np.ones((T, N), np.float32)
    if ragged:  # one padded point, as the learner pads: zero input and target
        mask[2, 4] = 0.0
        x[2, 4], y[2, 4] = 0.0, 0.0
    hp = fk.fused_prior(D, HIDDEN, WPS, BPS)
    theta = (hp.loc + hp.scale * torch.from_numpy(rs.randn(K, hp.dim).astype(np.float32)))
    mu = torch.from_numpy((0.01 * rs.randn(K, hp.dim)).astype(np.float32))
    nu = torch.from_numpy((1e-4 * rs.rand(K, hp.dim)).astype(np.float32))
    return x, y, mask, theta.numpy(), mu.numpy(), nu.numpy()


def _keep(hp):
    keep = np.ones(hp.dim, bool)
    keep[hp.slice_of(("kernel_nn", "b_out"))] = False
    return keep


def _jax_fused_steps(x, y, mask, theta, mu, nu, w_t, step0, n_steps, counts=None):
    cfg = jax_random_gp.random_gp_config(D, feature_dim=1, mean_nn_layers=HIDDEN,
                                         kernel_nn_layers=HIDDEN)
    hp = jax_random_gp.make_hyper_prior(cfg, weight_prior_std=WPS, bias_prior_std=BPS)
    packed = [pack_state(hp, jnp.asarray(a), HIDDEN) for a in (theta, mu, nu)]
    pages = None
    if counts is not None:  # [n_steps, Tpad8, 128], counts in lane 0
        pages = np.zeros((n_steps, 8, 128), np.float32)
        pages[:, :T, 0] = counts
        pages = jnp.asarray(pages)

    def n_major(a):
        return jnp.asarray(np.transpose(a, (1, 0, 2)).reshape(N * T, -1))

    out = fused_svgd_train_packed(
        *packed, n_major(x), n_major(y[..., None]), n_major(mask[..., None]),
        jnp.asarray(w_t.reshape(T, 1)), float(step0), K=K, T=T, N=N, D=D, hidden=HIDDEN,
        lr=LR, prior_factor=PF, wps=WPS, bps=BPS, n_steps=n_steps, interpret=True,
        counts_pages=pages)
    return [np.asarray(unpack_state(hp, o, HIDDEN, K)) for o in out]


@pytest.mark.parametrize("mode", ["full_batch", "counted"])
def test_plain_fused_steps_match_pallas_kernel(mode):
    """Three steps from one state (non-zero Adam moments, step0 7): particles
    and Adam m, v agree to atol 3e-4, a few lr-quanta of Adam's sign-like
    early steps (the reason tests/test_fused_svgd.py:104-106 gives); 5e-7
    measured. The counted mode feeds both sides the same numpy count pages,
    one task never drawn in the first step."""
    counted = mode == "counted"
    x, y, mask, theta, mu, nu = _inputs(seed=1, ragged=not counted)
    counts = None
    if counted:
        counts = np.array([[2, 0, 1, 1], [0, 1, 1, 2], [1, 1, 1, 1]], np.float32)
    w_t = fk.task_weights(mask, 4 if counted else None)
    want = _jax_fused_steps(x, y, mask, theta, mu, nu, w_t, 7, 3, counts)

    got = [torch.from_numpy(a.copy()) for a in (theta, mu, nu)]
    fk.fused_svgd_train(*got, torch.from_numpy(x), torch.from_numpy(y),
                        torch.from_numpy(mask), torch.from_numpy(w_t), 7, LR, PF,
                        None if counts is None else torch.from_numpy(counts),
                        hidden=HIDDEN, wps=WPS, bps=BPS, n_steps=3)
    keep = _keep(fk.fused_prior(D, HIDDEN, WPS, BPS))
    for name, g, w in zip(("theta", "m", "v"), got, want):
        diff = np.abs(g.numpy() - w)[:, keep]
        assert diff.max() <= 3e-4, (name, diff.max())
    assert np.abs(got[0].numpy() - theta)[:, keep].max() > 1e-3  # the steps moved it


def test_counted_meta_log_prob_matches_jax_and_gathering():
    """meta_log_prob(counts=) equals the JAX estimator (rtol 1e-5) and the
    gathered batch; a never-drawn task with NaN data adds exactly 0."""
    x, y, mask, theta, _, _ = _inputs(seed=2, ragged=False)
    counts = np.array([2.0, 0.0, 1.0, 1.0], np.float32)
    y_nan = y.copy()
    y_nan[1] = np.nan
    hp = fk.fused_prior(D, HIDDEN, WPS, BPS)
    got = random_gp.meta_log_prob(hp, PF, torch.from_numpy(theta), torch.from_numpy(x),
                                  torch.from_numpy(y_nan), torch.from_numpy(mask),
                                  counts=torch.from_numpy(counts))
    cfg = jax_random_gp.random_gp_config(D, feature_dim=1, mean_nn_layers=HIDDEN,
                                         kernel_nn_layers=HIDDEN)
    jhp = jax_random_gp.make_hyper_prior(cfg, weight_prior_std=WPS, bias_prior_std=BPS)
    want = jax_random_gp.meta_log_prob(jhp, PF, jnp.asarray(theta), jnp.asarray(x),
                                       jnp.asarray(y_nan), jnp.asarray(mask),
                                       counts=jnp.asarray(counts))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    idx = torch.tensor([0, 0, 2, 3])
    gathered = random_gp.meta_log_prob(hp, PF, torch.from_numpy(theta),
                                       torch.from_numpy(x)[idx], torch.from_numpy(y)[idx],
                                       torch.from_numpy(mask)[idx])
    np.testing.assert_allclose(got.numpy(), gathered.numpy(), rtol=1e-5)


@pytest.mark.parametrize("step0,n_steps,cap,decay", [
    (0, 10, 10, 1.0), (0, 10, 3, 1.0), (0, 2500, 10000, 0.5), (999, 3, 512, 0.5),
    (1700, 1500, 512, 0.5), (4000, 0, 512, 0.9), (5, 7, 1, 0.5)])
def test_launch_sched_matches_jax(step0, n_steps, cap, decay):
    got = list(launch_sched.staircase_launches(step0, n_steps, cap, decay))
    want = list(jax_sched.staircase_launches(step0, n_steps, cap, decay))
    assert got == want
    for s, _ in got:
        assert launch_sched.staircase_lr(1e-3, decay, s) == jax_sched.staircase_lr(1e-3, decay, s)
    assert launch_sched.staircase_lr(1e-3, decay, step0, transition=7) == \
        jax_sched.staircase_lr(1e-3, decay, step0, transition=7)


def _sin_tasks(n_tasks=T, n_samples=N, ragged=False):
    env = SinusoidDataset(random_state=np.random.RandomState(26))
    tasks = env.generate_meta_train_data(n_tasks=n_tasks, n_samples=n_samples)
    if ragged:
        tasks[1] = (tasks[1][0][:3], tasks[1][1][:3])
    return tasks


GATE_CASES = {
    "sin_like": dict(),
    "lr_decay": dict(lr_decay=0.5),
    "ragged_full_batch": dict(ragged=True),
    "counted_uniform": dict(task_batch_size=2),
    "counted_ragged": dict(task_batch_size=2, ragged=True),
    "n12": dict(n_samples=12),
    "se_covar": dict(covar_module="SE"),
    "feature_dim_2": dict(feature_dim=2),
    "unequal_widths": dict(kernel_nn_layers=(8, 4)),
    "two_widths": dict(mean_nn_layers=(8, 4), kernel_nn_layers=(8, 4)),
    "kh_over_1024": dict(num_particles=33, mean_nn_layers=(32, 32),
                         kernel_nn_layers=(32, 32)),
    "sgd": dict(optimizer="SGD"),
    "bandwidth": dict(bandwidth=1.0),
    "imq": dict(kernel="IMQ"),
    # sin_20's learner at the task counts of baseline_comparison_n_tasks: the
    # JAX learner's gate has no task bound
    **{f"sin_{t}_32x32": dict(n_tasks=t, num_particles=10, mean_nn_layers=(32, 32),
                              kernel_nn_layers=(32, 32)) for t in (60, 160, 320)},
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_learner_gate_matches_jax(jax_fused, monkeypatch, case):
    """The port takes the fused path exactly where the JAX learner does
    (Pallas forced, counted batches on as on the TPU, the JAX learner's
    big-N fused path forced on: the port's H100 policy)."""
    monkeypatch.setenv("PACOH_TPU_FORCE_BIGN_FUSED", "1")
    kw = dict(KW, **GATE_CASES[case])
    tasks = _sin_tasks(n_tasks=kw.pop("n_tasks", T), n_samples=kw.pop("n_samples", N),
                       ragged=kw.pop("ragged", False))
    want = JaxSVGD(tasks, **kw)._fused_path_ok()
    assert GPRegressionMetaLearnedSVGD(tasks, device="cpu", **kw)._fused_path_ok() == want
    assert want == (case in ("sin_like", "lr_decay", "ragged_full_batch", "counted_uniform",
                             "n12") or case.startswith("sin_"))


def test_gate_follows_the_switches(monkeypatch):
    model = GPRegressionMetaLearnedSVGD(_sin_tasks(), device="cpu", **KW)
    assert model._fused_path_ok()
    monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")
    assert not model._fused_path_ok()
    monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "0")
    monkeypatch.setenv("PACOH_TORCH_DISABLE_KERNELS", "1")
    assert not model._fused_path_ok()


def test_slice_matches_jax_fused_learner(jax_fused):
    """The JAX learner on a sin_20-like set, fused path in interpret mode,
    3 steps; the port learner loads its state_dict; both run 5 more steps.
    Particles max 2e-5, mean 1e-7 (1.5e-6 and 7e-9 measured: float32 sums
    in another order); predictions and eval metrics rtol 1e-4 (1.5e-6
    measured)."""
    tasks = _sin_tasks()
    env = SinusoidDataset(random_state=np.random.RandomState(27))
    test = env.generate_meta_test_data(n_tasks=3, n_samples_context=5, n_samples_test=20)
    jax_model = JaxSVGD(tasks, **KW)
    jax_model.meta_fit(n_iter=3, log_period=3, verbose=False)
    assert jax_model._fused is not None
    port = GPRegressionMetaLearnedSVGD(tasks, device="cpu", **KW)
    port.load_state_dict(jax_model.state_dict())
    assert port._fused_path_ok()

    jax_model.meta_fit(n_iter=5, log_period=5, verbose=False)
    port.meta_fit(n_iter=5, log_period=5, verbose=False)
    assert port._fused is not None
    assert port.state_dict()["step"] == jax_model.state_dict()["step"] == 8
    assert port.state_dict()["opt_state"]["count"] == 8

    keep = _keep(port.hyper_prior)
    diff = np.abs(port.particles.numpy() - np.asarray(jax_model.particles))[:, keep]
    assert diff.max() <= 2e-5 and diff.mean() <= 1e-7, (diff.max(), diff.mean())
    mean, std = port.predict(*test[0][:3])
    mean_j, std_j = jax_model.predict(*test[0][:3])
    np.testing.assert_allclose(mean, mean_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(std, std_j, rtol=1e-4)
    np.testing.assert_allclose(port.eval_datasets(test), jax_model.eval_datasets(test),
                               rtol=1e-4, atol=1e-5)


def test_fused_resume_equals_general_steps(monkeypatch):
    """2 general steps then 3 fused steps against 5 general steps from one
    seed: the same bits (one score, one Stein transport, one Adam,
    ``cuda.adam_step_``, on both paths)."""
    tasks = _sin_tasks()
    monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")
    general = GPRegressionMetaLearnedSVGD(tasks, device="cpu", **KW)
    general.meta_fit(n_iter=5, verbose=False)
    mixed = GPRegressionMetaLearnedSVGD(tasks, device="cpu", **KW)
    mixed.meta_fit(n_iter=2, verbose=False)
    monkeypatch.delenv("PACOH_TORCH_DISABLE_FUSED")
    mixed.meta_fit(n_iter=3, verbose=False)
    assert mixed._fused is not None and general._fused is None
    assert mixed._step_count == mixed._adam_count == 5
    assert torch.equal(mixed.particles, general.particles)
    assert torch.equal(mixed._mu, general._mu) and torch.equal(mixed._nu, general._nu)


@pytest.mark.parametrize("task_batch_size", [-1, 2])
def test_fused_chunkings_are_bit_identical(monkeypatch, task_batch_size):
    """One chunk, chunks of 2, and a state_dict round trip mid-fit give the
    same bits, across staircase boundaries (transition shrunk to 2)."""
    monkeypatch.setattr(launch_sched, "LR_TRANSITION_STEPS", 2)
    kw = dict(KW, lr_decay=0.5, task_batch_size=task_batch_size)
    tasks = _sin_tasks()
    one = GPRegressionMetaLearnedSVGD(tasks, device="cpu", **kw)
    one.meta_fit(n_iter=5, log_period=5, verbose=False)
    chunked = GPRegressionMetaLearnedSVGD(tasks, device="cpu", **kw)
    chunked.meta_fit(n_iter=5, log_period=2, verbose=False)
    resumed = GPRegressionMetaLearnedSVGD(tasks, device="cpu", **kw)
    resumed.meta_fit(n_iter=3, verbose=False)
    fresh = GPRegressionMetaLearnedSVGD(tasks, device="cpu", **kw)
    fresh.load_state_dict(resumed.state_dict())
    fresh.meta_fit(n_iter=2, verbose=False)
    assert one._fused is not None
    for other in (chunked, fresh):
        assert torch.equal(one.particles, other.particles)
        assert torch.equal(one._mu, other._mu) and torch.equal(one._nu, other._nu)
    assert torch.isfinite(one.particles).all()


def test_counted_trainer_draws_the_general_steps_tasks():
    """The fused trainer's count pages are the general step's own draws."""
    model = GPRegressionMetaLearnedSVGD(_sin_tasks(), device="cpu", **dict(KW, task_batch_size=3))
    trainer = fk.FusedSVGDTrainer(
        model.X, model.Y, model.mask, hidden=HIDDEN, lr=LR, prior_factor=PF,
        weight_prior_std=WPS, bias_prior_std=BPS, task_batch_size=3,
        task_draw=model._task_draw)
    pages = trainer.count_pages(10, 4)
    for i in range(4):
        want = torch.bincount(model._task_draw(10 + i), minlength=T).float()
        assert torch.equal(pages[i], want) and float(pages[i].sum()) == 3.0
    assert list(trainer.launches(10, 1100)) == [(10, 512), (522, 512), (1034, 76)]


def test_wrapper_checks_its_operands():
    x, y, mask, theta, mu, nu = _inputs(seed=3, ragged=False)
    args = [torch.from_numpy(a) for a in (theta, mu, nu, x, y, mask)]
    wrong_w = torch.ones(T)
    with pytest.raises(ValueError):
        fk.fused_svgd_train(*args, wrong_w, 0, LR, PF, hidden=HIDDEN, wps=WPS, bps=BPS,
                            n_steps=1)
    assert fk.fused_svgd_fits(10, 20, 5, 1, (32, 32))
    assert not fk.fused_svgd_fits(33, 20, 5, 1, (32, 32))
    assert not fk.fused_svgd_fits(10, 20, 9, 1, (32, 32))
    assert fk.fused_svgd_fits(10, 2000, 8, 1, (32, 32))  # any task count: tiles
    assert not fk.fused_svgd_fits(10, 20, 5, 1, (256, 256))  # shared memory
