"""The port's big-N fused PACOH-MAP training kernel (B9) against the JAX package's.

On the CPU ``fused_map_bign_train`` takes its plain version (autograd of
the kernel's loss, ``bign_task_mll``, and the AdamW of the N <= 8 kernel);
the JAX side is the JAX learner's XLA step, the JAX ``gp_prior_mll_batch``
and ``jax.grad``, or the Pallas kernel ``fused_map_bign_train_packed`` in
interpret mode, as tests/test_fused_map_bign.py runs them. Both start from
the JAX learner's parameters, carried over by ``interop.from_jax_map_state``
(``load_state_dict``). Sizes are that file's: nets (8, 8), F=2, tasks of
N=12 points (ragged) and N=72; and three steps at the full width of
bench.py's ``map_t5_n200``.

Parameter comparisons leave out the kernel net's output bias: its true
gradient is exactly zero, so both sides random-walk float noise there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_learning_pacoh_tpu import GPRegressionMetaLearned as JaxMAP
from meta_learning_pacoh_tpu.models.gp_base import gp_prior_mll_batch as jax_mll_batch
from meta_learning_pacoh_tpu.ops.pallas.fused_map_bign_kernel import (
    FusedMAPBigNTrainer as JaxBigNTrainer,
)
from meta_learning_pacoh_tpu.utils import jit_cache
from meta_learning_pacoh_torch import GPRegressionMetaLearned
from meta_learning_pacoh_torch.datasets import SinusoidDataset
from meta_learning_pacoh_torch.interop import params_from_jax
from meta_learning_pacoh_torch.models.gp_base import gp_gram, gp_noise, gp_prior_mll_batch
from meta_learning_pacoh_torch.models.random_gp import layout_slice, unravel_flat
from meta_learning_pacoh_torch.ops import gp as gp_ops
from meta_learning_pacoh_torch.ops import launch_sched
from meta_learning_pacoh_torch.ops.cuda import fused_map_bign_kernel as bg
from meta_learning_pacoh_torch.ops.cuda.chol_kernel import cholesky_ref, diag_ok

KW = dict(mean_nn_layers=(8, 8), kernel_nn_layers=(8, 8), weight_decay=0.2, lr_params=1e-3,
          feature_dim=2, task_batch_size=-1)


@pytest.fixture(autouse=True)
def jax_general_step(monkeypatch):
    """The JAX learner's XLA step and the port's fused path; the JAX jit
    cache keys ignore the environment, so it is cleared around every test."""
    for name in ("PACOH_TPU_FORCE_PALLAS", "PACOH_TPU_MAP_WEIGHTED", "PACOH_TORCH_DISABLE_FUSED",
                 "PACOH_TORCH_DISABLE_KERNELS"):
        monkeypatch.delenv(name, raising=False)
    jit_cache.clear()
    yield
    jit_cache.clear()


def _tasks(n_tasks=3, n_samples=12, ragged=True, seed=26):
    """tests/test_fused_map_bign.py's tasks: later tasks 2 points shorter each."""
    env = SinusoidDataset(random_state=np.random.RandomState(seed))
    mt = env.generate_meta_train_data(n_tasks=n_tasks, n_samples=n_samples)
    if ragged:
        mt = [(x[:n_samples - 2 * i], y[:n_samples - 2 * i]) for i, (x, y) in enumerate(mt)]
    return mt


def _pair(tasks, seed=30, **kw):
    """A JAX learner and the port's learner started from its state."""
    kw = dict(KW, random_seed=seed, **kw)
    jax_model = JaxMAP(tasks, **kw)
    port = GPRegressionMetaLearned(tasks, device="cpu", **kw)
    port.load_state_dict(jax_model.state_dict())
    return jax_model, port


def _keep(port):
    keep = np.ones(port.params.numel(), bool)
    keep[layout_slice(port.layout, ("kernel_nn", "b_out"))] = False
    return keep


def _jax_grad(jax_model):
    def loss(p):
        return -jnp.sum(jax_mll_batch(jax_model.cfg, p, jnp.asarray(jax_model.X),
                                      jnp.asarray(jax_model.Y), jnp.asarray(jax_model.mask)))

    value, grad = jax.value_and_grad(loss)(jax_model.params)
    return float(value), params_from_jax(grad)


def _port_steps(port, n_steps, counts=None):
    """n_steps of the port's kernel (its plain version here) from the
    learner's state with fresh moments -> (theta, m, v, last loss)."""
    state = [port.params.clone(), torch.zeros_like(port.params), torch.zeros_like(port.params)]
    w_t = torch.from_numpy(bg.task_weights(port.mask.numpy()))
    last, _ = bg.fused_map_bign_train(*state, port.X, port.Y, port.mask, w_t, 0, 1e-3, 0.2,
                                      counts, layout=port.layout, n_steps=n_steps)
    return [s.numpy() for s in state] + [float(last)]


@pytest.mark.parametrize("ragged,n", [(True, 12), (False, 72)])
def test_loss_and_first_moment_match_jax(ragged, n):
    """At the JAX learner's initial parameters: the first step's loss equals
    -sum of the JAX ``gp_prior_mll_batch`` (rtol 1e-5), and the AdamW moment
    m after one step from m = 0 is 0.1 times the gradient, which matches
    ``jax.grad`` at atol 2e-5 of the leaf's scale + 1e-6 (the tolerances of
    tests/test_fused_map_bign.py). N=72 runs the multi-panel factorization."""
    jax_model, port = _pair(_tasks(n_tasks=3 if ragged else 2, n_samples=n, ragged=ragged))
    assert port._fused_path_ok()
    _, m, _, loss = _port_steps(port, 1)
    want_loss, want_grad = _jax_grad(jax_model)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for path, _, offset, size in port.layout:
        sl = slice(offset, offset + size)
        scale = max(float(np.abs(want_grad[sl]).max()), 1e-3)
        np.testing.assert_allclose(m[sl] / 0.1, want_grad[sl], rtol=0, atol=2e-5 * scale + 1e-6,
                                   err_msg=str(path))


def test_three_steps_match_jax_xla_step():
    """Three full-batch steps on ragged tasks against the JAX learner's
    jitted XLA step: parameters atol 3e-4, AdamW m atol 5e-4 of its scale
    + 1e-4 (tests/test_fused_map_bign.py's tolerances); 1e-6 measured."""
    jax_model, port = _pair(_tasks())
    params, opt_state, losses = jax_model._step_fn(
        jax_model.params, jax_model.opt_state, jax_model.X, jax_model.Y, jax_model.mask,
        jax_model._train_key, 0, 3)
    theta, m, _, loss = _port_steps(port, 3)
    keep = _keep(port)
    np.testing.assert_allclose(theta[keep], params_from_jax(params)[keep], rtol=0, atol=3e-4)
    adam = opt_state.inner_states["train"].inner_state[0]
    want_m = params_from_jax(adam.mu)
    scale = max(float(np.abs(want_m).max()), 1e-3)
    np.testing.assert_allclose(m[keep], want_m[keep], rtol=0, atol=5e-4 * scale + 1e-4)
    np.testing.assert_allclose(loss, float(losses[-1]), rtol=1e-5)


def test_plain_version_matches_jax_kernel_in_interpret_mode():
    """Two steps of the port's plain version against two of the Pallas
    kernel (interpret mode) from the same state, ragged tasks: parameters
    atol 1e-5, the last loss rtol 1e-5."""
    jax_model, port = _pair(_tasks())
    tr = JaxBigNTrainer(jax_model.params, jax_model.X, jax_model.Y, jax_model.mask,
                        feature_dim=2, mean_hidden=(8, 8), kernel_hidden=(8, 8), lr=1e-3,
                        weight_decay=0.2, noise_floor=jax_model.cfg.noise_floor, interpret=True)
    tr.run(2, 0)
    want_params, _, _ = tr.sync()
    theta, _, _, loss = _port_steps(port, 2)
    keep = _keep(port)
    np.testing.assert_allclose(theta[keep], params_from_jax(want_params)[keep], rtol=0, atol=1e-5)
    np.testing.assert_allclose(loss, float(tr.last_loss), rtol=1e-5)


def _jax_draws(jax_model, n_steps):
    """The JAX learner's task indices of steps 0 .. n_steps - 1 (fold_in, randint)."""
    keys = jax.vmap(lambda i: jax.random.fold_in(jax_model._train_key, i))(np.arange(n_steps))
    draw = jax.vmap(lambda k: jax.random.randint(k, (jax_model.task_batch_size,), 0,
                                                 jax_model.n_tasks))
    return np.asarray(draw(keys)).astype(np.int64)


def test_counted_trajectory_matches_jax(monkeypatch):
    """Ten count-weighted steps (batch 2 of 4 tasks of N=12) through the
    port's big-N fused path, drawing the JAX learner's own task indices,
    against the JAX learner's counted XLA step: parameters atol 1e-5, the
    last loss rtol 1e-5."""
    monkeypatch.setenv("PACOH_TPU_MAP_WEIGHTED", "1")
    jax_model, port = _pair(_tasks(n_tasks=4, ragged=False), seed=7, task_batch_size=2)
    assert port._fused_path_ok() and jax_model._weight_by_counts()
    idx = torch.from_numpy(_jax_draws(jax_model, 10))
    assert len({tuple(sorted(i)) for i in idx.tolist()}) > 1
    port._task_draw = lambda step: idx[step]
    want_loss = jax_model.meta_fit(n_iter=10, log_period=10, verbose=False)
    got_loss = port.meta_fit(n_iter=10, log_period=10, verbose=False)
    assert type(port._fused) is bg.FusedMAPBigNTrainer
    keep = _keep(port)
    np.testing.assert_allclose(port.params.numpy()[keep], params_from_jax(jax_model.params)[keep],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)


def test_chunkings_and_resume_are_bit_identical(monkeypatch):
    """Count-weighted batches and a staircase lr (transition 2) through the
    big-N fused path: one chunk, chunks of 2, and a state_dict resume
    mid-fit give the same bits."""
    monkeypatch.setattr(launch_sched, "LR_TRANSITION_STEPS", 2)
    tasks = _tasks(n_tasks=4)
    kw = dict(KW, task_batch_size=3, lr_decay=0.5, random_seed=3)
    one = GPRegressionMetaLearned(tasks, device="cpu", **kw)
    assert one._fused_path_ok()
    one.meta_fit(n_iter=7, log_period=7, verbose=False)
    chunked = GPRegressionMetaLearned(tasks, device="cpu", **kw)
    chunked.meta_fit(n_iter=7, log_period=2, verbose=False)
    resumed = GPRegressionMetaLearned(tasks, device="cpu", **kw)
    resumed.meta_fit(n_iter=4, verbose=False)
    fresh = GPRegressionMetaLearned(tasks, device="cpu", **kw)
    fresh.load_state_dict(resumed.state_dict())
    fresh.meta_fit(n_iter=3, verbose=False)
    for other in (chunked, fresh):
        assert torch.equal(one.params, other.params)
        assert torch.equal(one._mu, other._mu) and torch.equal(one._nu, other._nu)
    assert type(fresh._fused) is bg.FusedMAPBigNTrainer
    assert torch.isfinite(one.params).all()


def test_ragged_task_that_escalates_puts_jitter_on_real_rows_only():
    """A huge outputscale and a near-zero noise (raw -20) make the float32
    factorization of near-duplicate points fail at jitter 0: the first
    outputscale of a sweep at which a ragged task (10 or 8 real points of
    12) escalates to 1e-4 or 1e-2 and still factors. B9's rule puts the
    jitter j on the n_t real diagonal entries only, the general step's
    (``gp_prior_mll_batch``) on all 12: the quadratic forms agree and the
    log-determinants differ by the padded rows' (12 - n_t) log(1 + j), so
    each task's MLL / n_t by (12 - n_t) log(1 + j) / (2 n_t) (atol 2e-6,
    float32 sums of about 50). The gradient through it is finite."""
    port = GPRegressionMetaLearned(_tasks(), device="cpu", random_seed=30, **KW)
    n_real = port.mask.sum(-1)
    assert n_real.tolist() == [12.0, 10.0, 8.0]
    for os_raw in (3e3, 1e4, 2e4, 3e4, 5e4, 1e5):
        theta = port.params.clone()
        for leaf, value in ((("outputscale_raw",), os_raw), (("lengthscale_raw",), 1.0),
                            (("noise_raw",), -20.0)):
            theta[layout_slice(port.layout, leaf)] = value
        params = unravel_flat(port.layout, theta[None])
        levels = _levels(port, params)
        got = bg.bign_task_mll(port.layout, theta, port.X, port.Y, port.mask)
        if max(levels[1:]) > 0 and bool(torch.isfinite(got).all()):
            break
    else:
        pytest.fail("no ragged task escalated in the sweep")
    want = gp_prior_mll_batch(port.cfg, params, port.X, port.Y, port.mask)[0]
    jit = torch.tensor([bg.JITTERS[level] for level in levels])
    shift = (12 - n_real) * torch.log1p(jit) / (2 * n_real)
    np.testing.assert_allclose((got - want).numpy(), shift.numpy(), rtol=0, atol=2e-6)
    theta.requires_grad_(True)
    (grad,) = torch.autograd.grad(bg.bign_task_mll(port.layout, theta, port.X, port.Y,
                                                   port.mask).sum(), theta)
    assert torch.isfinite(grad).all()


def _levels(port, params):
    """The jitter level (0, 1, 2) of each task under B9's rule."""
    K = gp_gram(port.cfg, params, port.X[None])[0]
    kn = gp_ops.add_noise_masked(K, gp_noise(port.cfg, params)[0].expand(port.n_tasks),
                                 port.mask, 1e-6)
    eye_real = torch.diag_embed(port.mask)
    ok = [diag_ok(cholesky_ref(kn + j * eye_real)) for j in bg.JITTERS]
    return torch.where(ok[0], 0, torch.where(ok[1], 1, 2)).tolist()


# name -> (tasks, points, constructor keywords beyond KW, the gate's answer)
GATE_CASES = {
    "n12": (3, 12, {}, True),
    "map_t5_n200": (5, 200, dict(mean_nn_layers=(32, 32), kernel_nn_layers=(32, 32)), True),
    "sampled_batch": (5, 200, dict(task_batch_size=2), True),
    "n513": (2, 513, {}, False),
    "se_kernel": (3, 12, dict(covar_module="SE", learning_mode="learn_mean"), False),
    "constant_mean": (3, 12, dict(mean_module="constant", learning_mode="learn_kernel"), False),
    "feature_dim_9": (3, 12, dict(feature_dim=9), False),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_learner_gate_matches_jax(monkeypatch, case):
    """The port's learner takes the big-N fused path exactly where the JAX
    learner does on the TPU (Pallas forced, counted batches on)."""
    monkeypatch.setenv("PACOH_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("PACOH_TPU_MAP_WEIGHTED", "1")
    n_tasks, n_samples, kw, fits = GATE_CASES[case]
    tasks = _tasks(n_tasks=n_tasks, n_samples=n_samples, ragged=False)
    kw = dict(KW, **kw)
    assert JaxMAP(tasks, **kw)._fused_path_ok() == fits
    jit_cache.clear()
    assert GPRegressionMetaLearned(tasks, device="cpu", **kw)._fused_path_ok() == fits


@pytest.mark.parametrize("t,n,f,mh,fits", [
    (3, 12, 2, (8, 8), True),
    (5, 200, 2, (32, 32), True),
    (16, 512, 2, (32, 32), True),  # the matrix in device memory
    (1152, 64, 2, (32, 32), True),  # the JAX gate's largest T at N <= 64: 9 tasks a block
    (5, 8, 2, (32, 32), False),  # the N <= 8 kernel's
    (5, 513, 2, (32, 32), False),
    (5, 200, 9, (32, 32), False),
    (5, 200, 2, (), False),
    (5, 200, 2, (512, 512), False),  # the parameters outgrow shared memory
])
def test_bign_fits(t, n, f, mh, fits):
    assert bg.bign_fits(t, n, 1, f, mh, mh) == fits


def test_map_t5_n200_three_steps_match_jax():
    """bench.py's map_t5_n200 learner (5 tasks x 200 points, nets 32x32,
    F=2, full batch): three steps of the port's fused path (the plain
    version here) from the JAX learner's state against the JAX learner's
    XLA step: parameters atol 1e-5, losses rtol 1e-5."""
    env = SinusoidDataset(random_state=np.random.RandomState(5))
    tasks = env.generate_meta_train_data(n_tasks=5, n_samples=200)
    jax_model = JaxMAP(tasks, num_iter_fit=500, random_seed=1, task_batch_size=-1)
    port = GPRegressionMetaLearned(tasks, num_iter_fit=500, random_seed=1, task_batch_size=-1,
                                   device="cpu")
    port.load_state_dict(jax_model.state_dict())
    assert port._fused_path_ok() and port.params.numel() == 2343
    got = [port.meta_fit(n_iter=1, log_period=1, verbose=False) for _ in range(3)]
    want = [jax_model.meta_fit(n_iter=1, log_period=1, verbose=False) for _ in range(3)]
    assert type(port._fused) is bg.FusedMAPBigNTrainer
    np.testing.assert_allclose(got, want, rtol=1e-5)
    keep = _keep(port)
    np.testing.assert_allclose(port.params.numpy()[keep], params_from_jax(jax_model.params)[keep],
                               rtol=0, atol=1e-5)


def test_wrapper_checks():
    _, port = _pair(_tasks())
    args = [port.params.clone(), torch.zeros_like(port.params), torch.zeros_like(port.params),
            port.X, port.Y, port.mask]
    with pytest.raises(ValueError):  # w_t of the wrong weights
        bg.fused_map_bign_train(*args, torch.ones(3), 0, 1e-3, 0.2, layout=port.layout,
                                n_steps=1)
    with pytest.raises(ValueError):
        bg.fused_map_bign_train(*args, torch.from_numpy(bg.task_weights(port.mask.numpy())), 0,
                                1e-3, 0.2, layout=port.layout, n_steps=0)
