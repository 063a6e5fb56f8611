"""The port's big-N fused PACOH-SVGD training kernel (B10) against the JAX package's.

On the CPU ``fused_svgd_bign_train`` takes its plain version (autograd of
``meta_log_prob`` with the kernel's jitter rule, ``bign_prior_mll_batch``,
then ``svgd_phi_ref`` and the kernels' Adam); the JAX side runs the Pallas
kernel ``fused_svgd_bign_train_packed`` in interpret mode through its
``FusedSVGDBigNTrainer``, or its closed-form spec ``svgd_score_closed_form``,
as tests/test_fused_svgd_bign.py runs them. The port starts from the JAX
learner's state, carried over by ``interop.from_jax_state``
(``load_state_dict``). Sizes are that file's: K=4 particles, T=3 tasks of
N=12 points (ragged and not), hidden (8, 8).

Particle comparisons leave out the kernel net's output bias: its true
gradient is exactly zero, so both sides random-walk float noise there.
"""

import dataclasses

import numpy as np
import pytest
import torch

from meta_learning_pacoh_tpu import GPRegressionMetaLearnedSVGD as JaxSVGD
from meta_learning_pacoh_tpu.ops import fused_svgd_math
from meta_learning_pacoh_tpu.ops.pallas.fused_svgd_bign_kernel import (
    FusedSVGDBigNTrainer as JaxBigNTrainer,
)
from meta_learning_pacoh_tpu.utils import jit_cache
from meta_learning_pacoh_torch import GPRegressionMetaLearnedSVGD
from meta_learning_pacoh_torch.datasets import SinusoidDataset
from meta_learning_pacoh_torch.models.random_gp import meta_log_prob
from meta_learning_pacoh_torch.ops import cuda, launch_sched
from meta_learning_pacoh_torch.ops.cuda import fused_svgd_bign_kernel as sb
from meta_learning_pacoh_torch.ops.cuda import fused_svgd_kernel as fk

K, HIDDEN = 4, (8, 8)
WPS, BPS, PF, LR = 0.5, 3.0, 0.01, 1e-3
KW = dict(num_particles=K, mean_nn_layers=HIDDEN, kernel_nn_layers=HIDDEN, prior_factor=PF,
          weight_prior_std=WPS, bias_prior_std=BPS, lr=LR, task_batch_size=-1)


@pytest.fixture(autouse=True)
def clean_switches(monkeypatch):
    """Every switch unset; the JAX jit cache keys ignore the environment, so
    it is cleared around every test."""
    for name in ("PACOH_TPU_FORCE_PALLAS", "PACOH_TPU_SVGD_WEIGHTED", "PACOH_TPU_DISABLE_FUSED",
                 "PACOH_TPU_FORCE_BIGN_FUSED", "PACOH_TORCH_DISABLE_FUSED",
                 "PACOH_TORCH_DISABLE_KERNELS", "PACOH_TORCH_FORCE_BIGN_FUSED"):
        monkeypatch.delenv(name, raising=False)
    jit_cache.clear()
    yield
    jit_cache.clear()


def _tasks(n_tasks=3, n_samples=12, ragged=False, seed=26):
    """tests/test_fused_svgd_bign.py's tasks: later tasks 2 points shorter each."""
    env = SinusoidDataset(random_state=np.random.RandomState(seed))
    mt = env.generate_meta_train_data(n_tasks=n_tasks, n_samples=n_samples)
    if ragged:
        mt = [(x[:n_samples - 2 * i], y[:n_samples - 2 * i]) for i, (x, y) in enumerate(mt)]
    return mt


def _pair(tasks, seed=30, **kw):
    """A JAX learner and the port's learner started from its state."""
    kw = dict(KW, random_seed=seed, **kw)
    jax_model = JaxSVGD(tasks, **kw)
    port = GPRegressionMetaLearnedSVGD(tasks, device="cpu", **kw)
    port.load_state_dict(jax_model.state_dict())
    return jax_model, port


def _keep(port):
    keep = np.ones(port.hyper_prior.dim, bool)
    keep[port.hyper_prior.slice_of(("kernel_nn", "b_out"))] = False
    return keep


def _port_steps(port, n_steps, step0=0):
    """n_steps of the port's kernel (its plain version here) from the
    learner's particles with zero moments -> (theta, m, v) as numpy."""
    state = [port.particles.clone(), torch.zeros_like(port.particles),
             torch.zeros_like(port.particles)]
    w_t = torch.from_numpy(fk.task_weights(port.mask.numpy()))
    sb.fused_svgd_bign_train(*state, port.X, port.Y, port.mask, w_t, step0, LR, PF,
                             hidden=HIDDEN, wps=WPS, bps=BPS, n_steps=n_steps)
    return [s.numpy() for s in state]


@pytest.mark.parametrize("ragged", [False, True])
def test_plain_steps_match_jax_kernel_in_interpret_mode(ragged):
    """Three steps of the port's plain version against three of the Pallas
    kernel (interpret mode) from the JAX learner's particles: particles atol
    3e-4 and Adam m atol 5e-4 (tests/test_fused_svgd_bign.py:130-134's
    tolerances: early Adam steps act like sign(g), so a coordinate at a sign
    boundary moves by O(lr) between two float32 evaluations)."""
    jax_model, port = _pair(_tasks(ragged=ragged))
    assert port._fused_path_ok()
    tr = JaxBigNTrainer(jax_model.hyper_prior, jax_model.particles, jax_model.X, jax_model.Y,
                        jax_model.mask, hidden=HIDDEN, lr=LR, prior_factor=PF,
                        weight_prior_std=WPS, bias_prior_std=BPS, interpret=True)
    tr.run(3, 0)
    want = [np.asarray(a) for a in tr.sync()]
    got = _port_steps(port, 3)
    keep = _keep(port)
    for name, g, w, atol in zip(("theta", "m"), got, want, (3e-4, 5e-4)):
        np.testing.assert_allclose(g[:, keep], w[:, keep], rtol=0, atol=atol, err_msg=name)
    assert np.abs(got[0] - port.particles.numpy())[:, keep].max() > 1e-3  # the steps moved it


def test_score_matches_closed_form():
    """The score of the kernel's plain version (autograd of ``meta_log_prob``
    under the kernel's jitter rule), in float64, against the JAX closed-form
    spec ``svgd_score_closed_form`` (float32) at the JAX learner's
    particles, ragged tasks: every entry within 1e-5 of its particle's
    largest |entry| (7.7e-6 measured, the closed form's own float32 error;
    the plain version in float32 lies 9.6e-6 from its float64 score, so two
    float32 scores can part by 1.2e-5)."""
    jax_model, port = _pair(_tasks(ragged=True))
    blocks = fused_svgd_math.particles_to_blocks(jax_model.hyper_prior, jax_model.particles)
    score_blocks, _ = fused_svgd_math.svgd_score_closed_form(
        blocks, jax_model.X, jax_model.Y, jax_model.mask, prior_factor=PF,
        weight_prior_std=WPS, bias_prior_std=BPS)
    want = np.asarray(fused_svgd_math.blocks_to_particles(jax_model.hyper_prior, score_blocks))
    hp = port.hyper_prior
    hp64 = dataclasses.replace(hp, loc=hp.loc.double(), scale=hp.scale.double())
    theta = port.particles.double().requires_grad_(True)
    lp = meta_log_prob(hp64, PF, theta, port.X.double(), port.Y.double(), port.mask.double(),
                       task_mll=sb.bign_prior_mll_batch)
    (got,) = torch.autograd.grad(lp.sum(), theta)
    err = np.abs(got.numpy() - want) / np.abs(want).max(axis=1, keepdims=True)
    assert err.max() <= 1e-5, err.max()


# name -> (tasks, points, constructor keywords beyond KW, the gate's answer)
GATE_CASES = {
    "n9": (3, 9, {}, True),
    "n12": (3, 12, {}, True),
    "svgd_t5_n200": (5, 200, dict(num_particles=10, mean_nn_layers=(32, 32),
                                  kernel_nn_layers=(32, 32)), True),
    "n256": (2, 256, {}, True),
    "n257": (2, 257, {}, False),
    "sampled_batch": (4, 12, dict(task_batch_size=2), True),
    "se_covar": (3, 12, dict(covar_module="SE"), False),
    "feature_dim_2": (3, 12, dict(feature_dim=2), False),
    "kh_over_1024": (3, 12, dict(num_particles=33, mean_nn_layers=(32, 32),
                                 kernel_nn_layers=(32, 32)), False),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_learner_gate_matches_jax(monkeypatch, case):
    """The port's learner takes the big-N fused path exactly where the JAX
    learner does with its big-N kernel forced on (PACOH_TPU_FORCE_BIGN_FUSED=1:
    the port's H100 policy; Pallas in interpret mode, counted batches on as
    on the TPU)."""
    monkeypatch.setenv("PACOH_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("PACOH_TPU_SVGD_WEIGHTED", "1")
    monkeypatch.setenv("PACOH_TPU_FORCE_BIGN_FUSED", "1")
    n_tasks, n_samples, kw, fits = GATE_CASES[case]
    tasks = _tasks(n_tasks=n_tasks, n_samples=n_samples)
    kw = dict(KW, **kw)
    assert JaxSVGD(tasks, **kw)._fused_path_ok() == fits
    assert GPRegressionMetaLearnedSVGD(tasks, device="cpu", **kw)._fused_path_ok() == fits


def test_gate_follows_the_switches(monkeypatch):
    """In the window the learner takes B10 (the H100's policy), and
    PACOH_TORCH_DISABLE_FUSED or PACOH_TORCH_DISABLE_KERNELS turns it off."""
    model = GPRegressionMetaLearnedSVGD(_tasks(), device="cpu", **KW)
    assert model._fused_path_ok()
    monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")
    assert not model._fused_path_ok()
    monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "0")
    monkeypatch.setenv("PACOH_TORCH_DISABLE_KERNELS", "1")
    assert not model._fused_path_ok()


@pytest.mark.parametrize("n_tasks,default", [(102, True), (103, False)])
def test_gate_keeps_to_the_measured_shapes(monkeypatch, n_tasks, default):
    """The default takes the kernel up to the H100 faceoff's widest grouping,
    8 systems a block (10 x 102 = 1020 systems); at 10 x 103 (9 a block) it
    takes the general step, and PACOH_TORCH_FORCE_BIGN_FUSED=1 turns the
    kernel on."""
    model = GPRegressionMetaLearnedSVGD(_tasks(n_tasks=n_tasks, n_samples=9), device="cpu",
                  **dict(KW, num_particles=10))
    assert model._fused_path_ok() == default
    monkeypatch.setenv("PACOH_TORCH_FORCE_BIGN_FUSED", "1")
    assert model._fused_path_ok()


def _fit(tasks, fused, monkeypatch, n_iter=4, log_period=4, **kw):
    if not fused:
        monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")
    try:
        model = GPRegressionMetaLearnedSVGD(tasks, device="cpu", **dict(KW, random_seed=31, **kw))
        assert model._fused_path_ok() == fused
        model.meta_fit(n_iter=n_iter, log_period=log_period, verbose=False)
    finally:
        monkeypatch.delenv("PACOH_TORCH_DISABLE_FUSED", raising=False)
    return model


@pytest.mark.parametrize("batch", [-1, 2])
def test_fused_path_matches_general_step(monkeypatch, batch):
    """Four steps through the big-N fused path (its plain version here)
    against four general steps (the MLL kernels' plain versions at N=12)
    from one seed, full batch and a counted batch of 2 of 4 tasks (both
    paths draw the same tasks), with chip_smoke.py's tolerances for two
    float32 orders of a step: particles max 1e-4 and mean 2e-6, Adam moments
    within 1e-4 of their largest value (1.5e-5 and 1e-5 measured)."""
    tasks = _tasks(n_tasks=4, ragged=batch == -1)
    fused = _fit(tasks, True, monkeypatch, task_batch_size=batch)
    general = _fit(tasks, False, monkeypatch, task_batch_size=batch)
    assert type(fused._fused) is sb.FusedSVGDBigNTrainer and general._fused is None
    assert fused._fused.counted == (batch == 2)
    keep = _keep(fused)
    diff = np.abs(fused.particles.numpy() - general.particles.numpy())[:, keep]
    assert diff.max() <= 1e-4 and diff.mean() <= 2e-6, (diff.max(), diff.mean())
    for a, b in ((fused._mu, general._mu), (fused._nu, general._nu)):
        assert np.abs(a.numpy() - b.numpy())[:, keep].max() <= 1e-4 * np.abs(b.numpy()).max()


def test_chunkings_and_resume_are_bit_identical(monkeypatch):
    """Count-weighted batches and a staircase lr (transition 2) through the
    big-N fused path: one chunk, chunks of 2, and a state_dict resume
    mid-fit give the same bits."""
    monkeypatch.setattr(launch_sched, "LR_TRANSITION_STEPS", 2)
    tasks = _tasks(n_tasks=4)
    kw = dict(task_batch_size=3, lr_decay=0.5)
    one = _fit(tasks, True, monkeypatch, n_iter=7, log_period=7, **kw)
    chunked = _fit(tasks, True, monkeypatch, n_iter=7, log_period=2, **kw)
    resumed = _fit(tasks, True, monkeypatch, n_iter=4, **kw)
    fresh = GPRegressionMetaLearnedSVGD(tasks, device="cpu", **dict(KW, random_seed=31, **kw))
    fresh.load_state_dict(resumed.state_dict())
    fresh.meta_fit(n_iter=3, log_period=3, verbose=False)
    for other in (chunked, fresh):
        assert torch.equal(one.particles, other.particles)
        assert torch.equal(one._mu, other._mu) and torch.equal(one._nu, other._nu)
    assert type(fresh._fused) is sb.FusedSVGDBigNTrainer
    assert torch.isfinite(one.particles).all()


@pytest.mark.parametrize("k,t,n,hidden,plan", [
    (4, 3, 12, (8, 8), (12, 1, 2, 512)),
    (10, 5, 200, (32, 32), (50, 1, 2, 512)),  # svgd_t5_n200
    (10, 5, 201, (32, 32), (50, 1, 2, 512)),  # the largest N with the activations in shared memory
    (10, 5, 202, (32, 32), (50, 1, 1, 512)),  # the packed triangle alone
    (4, 2, 240, (128, 128), (8, 1, 0, 512)),  # wide nets: the matrix in device memory
    (10, 20, 20, (32, 32), (200, 1, 2, 256)),  # cauchy_20: one system a block, two blocks an SM
    (32, 1000, 64, (32, 32), (263, 122, 2, 256)),  # ceil(G / 264) systems a block
    (4, 33, 20, (32, 32), (66, 2, 2, 512)),  # G = 132: one block an SM
    (7, 19, 20, (32, 32), (133, 1, 2, 256)),  # G = 133: two
    # the largest N whose two blocks' shared memory fits an SM at nets 32x32, and the next
    (10, 20, 113, (32, 32), (200, 1, 2, 256)),
    (10, 20, 114, (32, 32), (100, 2, 2, 512)),
    (10, 20, 200, (32, 32), (100, 2, 2, 512)),  # 20 tasks of N=200: shared memory keeps one
    # N_WIDE (the kernel's largest N too): one block an SM by shared memory; beyond, no plan
    (10, 20, 256, (32, 32), (100, 2, 1, 512)),
    (10, 20, 257, (32, 32), None),
    (10, 5, 8, (32, 32), None),  # the N <= 8 kernel's
    (10, 5, 257, (32, 32), None),
    (33, 5, 200, (32, 32), None),
    (10, 5, 200, (32, 16), None),
])
def test_svgd_bign_plan(k, t, n, hidden, plan):
    assert sb.svgd_bign_plan(k, t, n, 1, hidden) == plan
    assert sb.svgd_bign_fits(k, t, n, 1, hidden) == (plan is not None)


@pytest.mark.parametrize("k,t,n,coresident", [(10, 20, 20, True), (10, 5, 200, False)])
def test_coresident_launches_are_counted(k, t, n, coresident, monkeypatch):
    """The wrapper counts a launch under ``fused_svgd_bign_coresident`` where
    its plan puts two blocks on an SM (cauchy_20's shape) and not elsewhere
    (svgd_t5_n200's): the C call replaced by a recorder on CPU tensors
    posing as the card's."""
    calls = []
    monkeypatch.setattr(sb, "launch", lambda name, ref, *args: calls.append(args))
    monkeypatch.setattr(cuda, "check_operand", lambda *a: None)
    monkeypatch.setattr(sb, "_device_operands", lambda *a: (torch.zeros(1),) * 3)
    monkeypatch.setattr(sb, "hidden_widths", lambda *a: torch.zeros(1))
    empty = torch.empty  # the wrapper's scratch, on the CPU
    monkeypatch.setattr(torch, "empty", lambda *shape, dtype, device: empty(*shape, dtype=dtype))
    hidden, d = (32, 32), 2
    p = fk.fused_prior(d, hidden, 1.0, 1.0).dim

    class Card(torch.Tensor):  # a CPU tensor that reports a CUDA device
        device = torch.device("cuda")

    def card(*shape):
        return torch.zeros(*shape).as_subclass(Card)

    monkeypatch.setattr(cuda, "LAUNCHES", dict.fromkeys(cuda.LAUNCHES, 0))
    sb.fused_svgd_bign_train(card(k, p), card(k, p), card(k, p), card(t, n, d), card(t, n),
                             card(t, n), card(t), 0, LR, PF, hidden=hidden, wps=WPS, bps=BPS,
                             n_steps=3)
    plan = sb.svgd_bign_plan(k, t, n, d, hidden)
    assert calls[0][-7:-3] == plan and (plan[3] == 256) == coresident
    assert cuda.LAUNCHES["fused_svgd_bign"] == 1
    assert cuda.LAUNCHES["fused_svgd_bign_coresident"] == int(coresident)


def test_wrapper_checks():
    _, port = _pair(_tasks())
    args = [port.particles.clone(), torch.zeros_like(port.particles),
            torch.zeros_like(port.particles), port.X, port.Y, port.mask]
    kw = dict(hidden=HIDDEN, wps=WPS, bps=BPS)
    with pytest.raises(ValueError):  # w_t of the wrong weights
        sb.fused_svgd_bign_train(*args, torch.ones(3), 0, LR, PF, n_steps=1, **kw)
    with pytest.raises(ValueError):
        sb.fused_svgd_bign_train(*args, torch.from_numpy(fk.task_weights(port.mask.numpy())), 0,
                                 LR, PF, n_steps=0, **kw)
    assert cuda.LAUNCHES["fused_svgd_bign"] == 0  # the CPU takes the plain version
