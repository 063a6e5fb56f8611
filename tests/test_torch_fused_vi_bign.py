"""The port's big-N fused PACOH-VI training kernel (B11) against the JAX package's.

On the CPU ``fused_vi_bign_train`` takes its plain version (autograd of the
negative ELBO with the kernel's jitter rule, ``bign_prior_mll_batch``, then
the kernels' Adam); the JAX side runs the Pallas kernel
``fused_vi_bign_train_packed`` in interpret mode through its
``FusedVIBigNTrainer``, as tests/test_fused_vi_bign.py runs it, and the port
is fed the JAX trainer's own noise (fold_in(base_key, step), split, normal):
torch cannot reproduce JAX's key chains. The port starts from the JAX
learner's posterior, carried over by ``interop.from_jax_vi_state``
(``load_state_dict``). Sizes are that file's: S=6 samples, T=3 tasks of N=12
points (ragged and not), hidden (8, 8).

Comparisons leave out the kernel net's output bias: its true gradient is
exactly zero, so both its loc and its log_scale random-walk float noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_learning_pacoh_tpu import GPRegressionMetaLearnedVI as JaxVI
from meta_learning_pacoh_tpu.ops.pallas.fused_vi_bign_kernel import (
    FusedVIBigNTrainer as JaxBigNTrainer,
)
from meta_learning_pacoh_tpu.utils import jit_cache
from meta_learning_pacoh_torch import GPRegressionMetaLearnedVI
from meta_learning_pacoh_torch.datasets import SinusoidDataset
from meta_learning_pacoh_torch.ops import cuda, launch_sched
from meta_learning_pacoh_torch.ops.cuda import fused_svgd_kernel as fk
from meta_learning_pacoh_torch.ops.cuda import fused_vi_bign_kernel as vb
from meta_learning_pacoh_torch.ops.cuda import fused_vi_kernel as vk

S, HIDDEN = 6, (8, 8)
WPS, BPS, PF, LR = 0.4, 3.0, 0.01, 1e-3
KW = dict(svi_batch_size=S, mean_nn_layers=HIDDEN, kernel_nn_layers=HIDDEN, prior_factor=PF,
          weight_prior_std=WPS, bias_prior_std=BPS, lr=LR, task_batch_size=-1)


@pytest.fixture(autouse=True)
def clean_switches(monkeypatch):
    """Every switch unset; the JAX jit cache keys ignore the environment, so
    it is cleared around every test."""
    for name in ("PACOH_TPU_FORCE_PALLAS", "PACOH_TPU_VI_WEIGHTED", "PACOH_TPU_DISABLE_FUSED",
                 "PACOH_TPU_FORCE_BIGN_FUSED", "PACOH_TORCH_DISABLE_FUSED",
                 "PACOH_TORCH_DISABLE_KERNELS", "PACOH_TORCH_FORCE_BIGN_FUSED"):
        monkeypatch.delenv(name, raising=False)
    jit_cache.clear()
    yield
    jit_cache.clear()


def _tasks(n_tasks=3, n_samples=12, ragged=False, seed=26):
    """Sinusoid tasks; ragged: later tasks 2 points shorter each."""
    env = SinusoidDataset(random_state=np.random.RandomState(seed))
    mt = env.generate_meta_train_data(n_tasks=n_tasks, n_samples=n_samples)
    if ragged:
        mt = [(x[:n_samples - 2 * i], y[:n_samples - 2 * i]) for i, (x, y) in enumerate(mt)]
    return mt


def _keep(port):
    keep = np.ones(port.hyper_prior.dim, bool)
    keep[port.hyper_prior.slice_of(("kernel_nn", "b_out"))] = False
    return keep


def _jax_eps(base_key, n_steps, p):
    """The JAX trainer's noise of steps 0 .. n_steps - 1 [n_steps, S, P]."""
    pages = []
    for i in range(n_steps):
        _, k_sample = jax.random.split(jax.random.fold_in(base_key, i))
        pages.append(np.asarray(jax.random.normal(k_sample, (S, p), jnp.float32)))
    return np.stack(pages)


@pytest.mark.parametrize("ragged", [False, True])
def test_plain_steps_match_jax_kernel_in_interpret_mode(ragged):
    """Three steps of the port's plain version against three of the Pallas
    kernel (interpret mode) from the JAX learner's posterior, with the JAX
    trainer's noise: loc and log_scale atol 3e-4, Adam m atol 5e-4, the last
    and the mean loss rtol 1e-4 (tests/test_fused_vi_bign.py:99-110's
    tolerances)."""
    tasks = _tasks(ragged=ragged)
    jax_model = JaxVI(tasks, random_seed=30, **KW)
    port = GPRegressionMetaLearnedVI(tasks, device="cpu", random_seed=30, **KW)
    port.load_state_dict(jax_model.state_dict())
    assert port._fused_path_ok()
    base_key = jax.random.PRNGKey(7)
    tr = JaxBigNTrainer(jax_model.hyper_prior, jax_model.posterior, jax_model.X, jax_model.Y,
                        jax_model.mask, hidden=HIDDEN, lr=LR, prior_factor=PF,
                        weight_prior_std=WPS, bias_prior_std=BPS, svi_batch_size=S,
                        base_key=base_key, interpret=True)
    tr.run(3, 0)
    want_post, want_m, _ = tr.sync()

    p = port.hyper_prior.dim
    eps = torch.from_numpy(_jax_eps(base_key, 3, p))
    state = [port.posterior["loc"].clone(), port.posterior["log_scale"].clone()]
    state += [torch.zeros(p) for _ in range(4)]
    mask_np = port.mask.numpy()
    last, mean = vb.fused_vi_bign_train(
        *state, port.X, port.Y, port.mask, torch.from_numpy(fk.task_weights(mask_np)), eps, 0,
        LR, PF, hidden=HIDDEN, wps=WPS, bps=BPS, mll_const=vk.mll_constant(mask_np), n_steps=3)
    keep = _keep(port)
    for i, key in enumerate(("loc", "log_scale")):
        np.testing.assert_allclose(state[i].numpy()[keep], np.asarray(want_post[key])[keep],
                                   rtol=0, atol=3e-4, err_msg=key)
        np.testing.assert_allclose(state[2 + i].numpy()[keep], np.asarray(want_m[key])[keep],
                                   rtol=0, atol=5e-4, err_msg=key)
    np.testing.assert_allclose(float(last), float(tr.last_loss), rtol=1e-4)
    np.testing.assert_allclose(float(mean), float(tr.avg_loss), rtol=1e-4)
    assert np.abs(state[0].numpy() - port.posterior["loc"].numpy())[keep].max() > 1e-3


# name -> (tasks, points, constructor keywords beyond KW, the gate's answer)
GATE_CASES = {
    "n9": (3, 9, {}, True),
    "n12": (3, 12, {}, True),
    "vi_t5_n200": (5, 200, dict(svi_batch_size=10, mean_nn_layers=(32, 32),
                                kernel_nn_layers=(32, 32)), True),
    "n256": (2, 256, {}, True),
    "n257": (2, 257, {}, False),
    "sampled_batch": (4, 12, dict(task_batch_size=2), True),
    "full_cov": (3, 12, dict(cov_type="full"), False),
    "feature_dim_2": (3, 12, dict(feature_dim=2), False),
    "sh_over_1024": (3, 12, dict(svi_batch_size=33, mean_nn_layers=(32,),
                                 kernel_nn_layers=(32,)), False),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_learner_gate_matches_jax(monkeypatch, case):
    """The port's learner takes the big-N fused path exactly where the JAX
    learner does with its big-N kernel forced on (PACOH_TPU_FORCE_BIGN_FUSED=1:
    the port's H100 policy; Pallas in interpret mode, counted batches on as
    on the TPU)."""
    monkeypatch.setenv("PACOH_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("PACOH_TPU_VI_WEIGHTED", "1")
    monkeypatch.setenv("PACOH_TPU_FORCE_BIGN_FUSED", "1")
    n_tasks, n_samples, kw, fits = GATE_CASES[case]
    tasks = _tasks(n_tasks=n_tasks, n_samples=n_samples)
    kw = dict(KW, **kw)
    assert JaxVI(tasks, **kw)._fused_path_ok() == fits
    assert GPRegressionMetaLearnedVI(tasks, device="cpu", **kw)._fused_path_ok() == fits


def test_gate_follows_the_switches(monkeypatch):
    """In the window the learner takes B11 (the H100's policy), and
    PACOH_TORCH_DISABLE_FUSED or PACOH_TORCH_DISABLE_KERNELS turns it off."""
    model = GPRegressionMetaLearnedVI(_tasks(), device="cpu", **KW)
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
    model = GPRegressionMetaLearnedVI(_tasks(n_tasks=n_tasks, n_samples=9), device="cpu",
                  **dict(KW, svi_batch_size=10))
    assert model._fused_path_ok() == default
    monkeypatch.setenv("PACOH_TORCH_FORCE_BIGN_FUSED", "1")
    assert model._fused_path_ok()


def _fit(tasks, fused, monkeypatch, n_iter=4, log_period=4, **kw):
    """A learner (seed 31) fitted through the big-N fused path or the
    general step -> (learner, the last step's loss)."""
    if not fused:
        monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")
    try:
        model = GPRegressionMetaLearnedVI(tasks, device="cpu", **dict(KW, random_seed=31, **kw))
        assert model._fused_path_ok() == fused
        loss = model.meta_fit(n_iter=n_iter, log_period=log_period, verbose=False)
    finally:
        monkeypatch.delenv("PACOH_TORCH_DISABLE_FUSED", raising=False)
    return model, loss


@pytest.mark.parametrize("batch", [-1, 2])
def test_fused_path_matches_general_step(monkeypatch, batch):
    """Four steps through the big-N fused path (its plain version here)
    against four general steps (the MLL kernels' plain versions at N=12)
    from one seed, with the same noise and task draws, full batch of ragged
    tasks and a counted batch of 2 of 4, with chip_smoke.py's tolerances for
    two float32 orders of a step: loc and log_scale max 1e-4 and mean 2e-6,
    the Adam moments within 1e-4 of their largest value, the last loss rtol
    1e-5 (no task escalates its jitter, so both jitter rules give one
    loss)."""
    tasks = _tasks(n_tasks=4, ragged=batch == -1)
    fused, fused_loss = _fit(tasks, True, monkeypatch, task_batch_size=batch)
    general, general_loss = _fit(tasks, False, monkeypatch, task_batch_size=batch)
    assert type(fused._fused) is vb.FusedVIBigNTrainer and general._fused is None
    assert fused._fused.counted == (batch == 2)
    keep = _keep(fused)
    for key in ("loc", "log_scale"):
        diff = np.abs(fused.posterior[key].numpy() - general.posterior[key].numpy())[keep]
        assert diff.max() <= 1e-4 and diff.mean() <= 2e-6, (key, diff.max(), diff.mean())
        for tree_f, tree_g in ((fused._mu, general._mu), (fused._nu, general._nu)):
            want = tree_g[key].numpy()
            assert np.abs(tree_f[key].numpy() - want)[keep].max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(fused_loss, general_loss, rtol=1e-5)


def test_chunkings_and_resume_are_bit_identical(monkeypatch):
    """Count-weighted batches and a staircase lr (transition 2) through the
    big-N fused path: one chunk, chunks of 2, and a state_dict resume
    mid-fit give the same bits."""
    monkeypatch.setattr(launch_sched, "LR_TRANSITION_STEPS", 2)
    tasks = _tasks(n_tasks=4)
    kw = dict(task_batch_size=3, lr_decay=0.5)
    one, _ = _fit(tasks, True, monkeypatch, n_iter=7, log_period=7, **kw)
    chunked, _ = _fit(tasks, True, monkeypatch, n_iter=7, log_period=2, **kw)
    resumed, _ = _fit(tasks, True, monkeypatch, n_iter=4, **kw)
    fresh = GPRegressionMetaLearnedVI(tasks, device="cpu", **dict(KW, random_seed=31, **kw))
    fresh.load_state_dict(resumed.state_dict())
    fresh.meta_fit(n_iter=3, log_period=3, verbose=False)
    for other in (chunked, fresh):
        for tree in ("posterior", "_mu", "_nu"):
            for key in ("loc", "log_scale"):
                assert torch.equal(getattr(one, tree)[key], getattr(other, tree)[key])
    assert type(fresh._fused) is vb.FusedVIBigNTrainer
    assert torch.isfinite(one.posterior["loc"]).all()


@pytest.mark.parametrize("s,t,n,hidden,plan", [
    (6, 3, 12, (8, 8), (18, 1, 2)),
    (10, 5, 200, (32, 32), (50, 1, 2)),  # vi_t5_n200
    (10, 5, 202, (32, 32), (50, 1, 2)),  # the largest N with the activations in shared memory
    (10, 5, 203, (32, 32), (50, 1, 1)),  # the packed triangle alone
    (4, 2, 240, (128, 128), (8, 1, 0)),  # wide nets: the matrix in device memory
    (32, 300, 20, (32, 32), (128, 75, 2)),
    (10, 5, 8, (32, 32), None),  # the N <= 8 kernel's
    (10, 5, 257, (32, 32), None),
    (33, 5, 200, (32,), None),
])
def test_vi_bign_plan(s, t, n, hidden, plan):
    assert vb.vi_bign_plan(s, t, n, 1, hidden) == plan
    assert vb.vi_bign_fits(s, t, n, 1, hidden) == (plan is not None)


def test_wrapper_checks():
    port = GPRegressionMetaLearnedVI(_tasks(), device="cpu", random_seed=3, **KW)
    p = port.hyper_prior.dim
    state = [port.posterior["loc"].clone(), port.posterior["log_scale"].clone()]
    state += [torch.zeros(p) for _ in range(4)]
    mask_np = port.mask.numpy()
    w_t = torch.from_numpy(fk.task_weights(mask_np))
    eps = torch.zeros(1, S, p)
    kw = dict(hidden=HIDDEN, wps=WPS, bps=BPS, mll_const=vk.mll_constant(mask_np))
    with pytest.raises(ValueError):  # w_t of the wrong weights
        vb.fused_vi_bign_train(*state, port.X, port.Y, port.mask, torch.ones(3), eps, 0, LR, PF,
                               n_steps=1, **kw)
    with pytest.raises(ValueError):
        vb.fused_vi_bign_train(*state, port.X, port.Y, port.mask, w_t, eps, 0, LR, PF,
                               n_steps=0, **kw)
    assert cuda.LAUNCHES["fused_vi_bign"] == 0  # the CPU takes the plain version
