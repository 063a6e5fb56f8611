"""The port's seed-parallel fits (parallel/seed_parallel.py) on the CPU.

Mirrors tests/test_seed_parallel.py for the port's six learner classes
(less the mesh tests: the port has no device mesh yet):

- PACOH-MAP and PACOH-SVGD, full batch (no draws): the port's stacked fit
  starts from the JAX learners' initial states (``load_state_dict`` of
  their ``state_dict()``) and is held to the JAX package's
  ``fit_models_parallel`` after 30 steps at the JAX test's own limits (rtol
  2e-4, atol 1e-5). The JAX SVGD side runs with ``PACOH_TPU_FORCE_PALLAS=1``,
  so its Stein transport is the Pallas kernel in interpret mode under
  ``jax.vmap`` and takes the median at rank K*K//2, as the port's K1 does.
  Both at the JAX test's widths (nets 32 x 32): at nets 8 x 8 seed 3's
  SVGD fit is chaotic to float32, where JAX's own sequential and vmapped
  fits part by 3.5e-4, and either from a float64 run by 2e-3, in 30 steps.
  The MAP comparison leaves out the kernel net's output bias, whose true
  gradient is exactly zero (both sides random-walk float noise there).
- PACOH-VI, PACOH-MLAP, MAML and the NP (their JAX parity stands per
  learner): the stacked fit against the port's sequential general-step fits
  (``PACOH_TORCH_DISABLE_FUSED=1``) at the same limits, with sampled task
  batches, so each seed's own draws are checked too.

Also: per-seed data, the config-mismatch raise, the ``sequential_fused``
route (bit-identical to per-model ``meta_fit``), ``'auto'``, the stacked
model functions against S single calls, and the Stein transport's seed axis
(K1's plain version) against the JAX package's ``jax.vmap(svgd_phi_fused)``
in interpret mode and against S single calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_learning_pacoh_tpu import GPRegressionMetaLearned as JaxMAP
from meta_learning_pacoh_tpu import GPRegressionMetaLearnedSVGD as JaxSVGD
from meta_learning_pacoh_tpu.ops.pallas.svgd_kernel import svgd_phi_fused as jax_svgd_phi
from meta_learning_pacoh_tpu.parallel import fit_models_parallel as jax_fit_parallel
from meta_learning_pacoh_tpu.utils import jit_cache
from meta_learning_pacoh_torch import (
    GPRegressionLearned,
    GPRegressionMetaLearned,
    GPRegressionMetaLearnedPAC,
    GPRegressionMetaLearnedSVGD,
    GPRegressionMetaLearnedVI,
    MAMLRegression,
    NPRegressionMetaLearned,
)
from meta_learning_pacoh_torch.interop import params_from_jax
from meta_learning_pacoh_torch.models.gp_base import gp_prior_mll_batch
from meta_learning_pacoh_torch.models.random_gp import (
    init_posterior,
    layout_slice,
    make_hyper_prior,
    meta_log_prob,
    neg_elbo,
    random_gp_config,
)
from meta_learning_pacoh_torch.ops.cuda import svgd_kernel
from meta_learning_pacoh_torch.ops.svgd import svgd_phi
from meta_learning_pacoh_torch.parallel import fit_models_parallel

SEEDS = [3, 11, 42]
RTOL, ATOL = 2e-4, 1e-5  # tests/test_seed_parallel.py's limits
SMALL = dict(mean_nn_layers=(8, 8), kernel_nn_layers=(8, 8))


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    """No switch leaks in; the JAX jit cache keys ignore the environment."""
    for name in ("PACOH_TPU_FORCE_PALLAS", "PACOH_TORCH_DISABLE_FUSED",
                 "PACOH_TORCH_DISABLE_KERNELS"):
        monkeypatch.delenv(name, raising=False)
    jit_cache.clear()
    yield
    jit_cache.clear()


def _tasks(n_tasks=8, n=5, seed=0, ragged=False):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n_tasks):
        x = rs.uniform(-5, 5, (n, 1))
        y = np.sin(x) + 2 + 0.05 * rs.normal(size=(n, 1))
        out.append((x, y))
    if ragged:
        out[1] = (out[1][0][:3], out[1][1][:3])
    return out


def _state(model):
    """Every array of the model's state_dict (state and moments), flat, float64."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, np.ndarray):
            out.append(np.asarray(t, np.float64).ravel())

    walk({k: v for k, v in model.state_dict().items() if k != "step"})
    return np.concatenate(out)


def _fit_sequential(build, seeds, n_iter, monkeypatch):
    """Each seed's own meta_fit through the general step."""
    monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")
    models = [build(s) for s in seeds]
    for m in models:
        m.meta_fit(n_iter=n_iter, log_period=n_iter, verbose=False)
    monkeypatch.delenv("PACOH_TORCH_DISABLE_FUSED")
    return models


def test_torch_map_stack_matches_jax_fit_models_parallel():
    """PACOH-MAP, full batch: the port's stacked fit from the JAX initial
    states against the JAX package's vmapped fit, 30 steps."""
    train = _tasks()
    kw = dict(num_iter_fit=30, weight_decay=0.1, task_batch_size=-1)
    jax_models = [JaxMAP(train, random_seed=s, **kw) for s in SEEDS]
    ports = []
    for s, jm in zip(SEEDS, jax_models):
        port = GPRegressionMetaLearned(train, random_seed=s, device="cpu", **kw)
        port.load_state_dict(jm.state_dict())
        ports.append(port)
    jax_fit_parallel(jax_models, n_iter=30)
    fit_models_parallel(ports, n_iter=30, prefer="vmap")
    keep = np.ones(ports[0].params.numel(), bool)
    keep[layout_slice(ports[0].layout, ("kernel_nn", "b_out"))] = False
    for s, jm, port in zip(SEEDS, jax_models, ports):
        assert port.fitted and port._step_count == 30 and port._adam_count == 30
        np.testing.assert_allclose(port.params.numpy()[keep], params_from_jax(jm.params)[keep],
                                   rtol=RTOL, atol=ATOL, err_msg=f"seed {s}")


def test_torch_svgd_stack_matches_jax_fit_models_parallel(monkeypatch):
    """PACOH-SVGD, full batch, K=3: the port's stacked fit (one Stein
    transport of [3, 3, P] a step) from the JAX initial particles against the JAX
    package's vmapped fit with the Pallas Stein kernel, 30 steps."""
    monkeypatch.setenv("PACOH_TPU_FORCE_PALLAS", "1")
    train = _tasks()
    kw = dict(num_iter_fit=30, num_particles=3, task_batch_size=-1)
    jax_models = [JaxSVGD(train, random_seed=s, **kw) for s in SEEDS]
    ports = []
    for s, jm in zip(SEEDS, jax_models):
        port = GPRegressionMetaLearnedSVGD(train, random_seed=s, device="cpu", **kw)
        port.load_state_dict(jm.state_dict())
        ports.append(port)
    jax_fit_parallel(jax_models, n_iter=30)
    fit_models_parallel(ports, n_iter=30, prefer="vmap")
    for s, jm, port in zip(SEEDS, jax_models, ports):
        assert port.fitted and port._step_count == 30
        np.testing.assert_allclose(port.particles.numpy(), np.asarray(jm.particles),
                                   rtol=RTOL, atol=ATOL, err_msg=f"seed {s}")


STACKED = {
    "vi": lambda s: GPRegressionMetaLearnedVI(_tasks(ragged=True), random_seed=s,
                                              svi_batch_size=2, task_batch_size=4,
                                              device="cpu", **SMALL),
    "mlap": lambda s: GPRegressionMetaLearnedPAC(_tasks(n_tasks=4), random_seed=s,
                                                 svi_batch_size=2, device="cpu"),
    "maml": lambda s: MAMLRegression(_tasks(), layer_sizes=(8, 8), random_seed=s,
                                     task_batch_size=3, device="cpu"),
    "np": lambda s: NPRegressionMetaLearned(_tasks(ragged=True), r_dim=8, z_dim=8, h_dim=8,
                                            random_seed=s, task_batch_size=3, device="cpu"),
    "svgd_sampled": lambda s: GPRegressionMetaLearnedSVGD(
        _tasks(), random_seed=s, num_particles=3, task_batch_size=3, device="cpu", **SMALL),
    "map_sampled": lambda s: GPRegressionMetaLearned(
        _tasks(ragged=True), random_seed=s, weight_decay=0.1, device="cpu", **SMALL),
}


@pytest.mark.parametrize("name", sorted(STACKED))
def test_torch_stack_matches_sequential_general_fits(name, monkeypatch):
    """The stacked fit of three seeds against each seed's own general-step
    meta_fit, 15 steps, each seed with its own draws (task batches; VI's
    and MLAP's noise; MAML's task batch; the NP's batch, shuffle and
    latents); every state and moment array."""
    build = STACKED[name]
    par = [build(s) for s in SEEDS]
    fit_models_parallel(par, n_iter=15, prefer="vmap")
    for s, ms, mp in zip(SEEDS, _fit_sequential(build, SEEDS, 15, monkeypatch), par):
        assert mp.fitted and mp._step_count == 15 and mp._adam_count == ms._adam_count
        np.testing.assert_allclose(_state(mp), _state(ms), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} seed {s}")


def test_torch_per_seed_data_stack_matches_sequential(monkeypatch):
    """Different meta-train draws per seed (the meta-overfitting sweep's
    shape): each seed held to its own fit; the models stay usable."""
    def build(s):
        return GPRegressionMetaLearned(_tasks(seed=s), random_seed=s, num_iter_fit=25,
                                       device="cpu", **SMALL)

    par = [build(s) for s in SEEDS]
    fit_models_parallel(par, n_iter=25, prefer="vmap")
    for s, ms, mp in zip(SEEDS, _fit_sequential(build, SEEDS, 25, monkeypatch), par):
        np.testing.assert_allclose(mp.params.numpy(), ms.params.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=f"seed {s}")
    x, y = _tasks(seed=SEEDS[1])[0]
    mean, std = par[1].predict(x, y, x)
    assert np.all(np.isfinite(mean)) and np.all(std > 0)


def test_torch_stack_config_mismatch_raises():
    train = _tasks()
    a = GPRegressionMetaLearned(train, random_seed=1, lr_params=1e-3, device="cpu")
    b = GPRegressionMetaLearned(train, random_seed=2, lr_params=3e-4, device="cpu")
    with pytest.raises(ValueError, match="lr_params"):
        fit_models_parallel([a, b], n_iter=2, prefer="vmap")
    with pytest.raises(ValueError, match="one class"):
        fit_models_parallel([a, MAMLRegression(train, device="cpu")], n_iter=2)
    c = GPRegressionMetaLearned(train, random_seed=3, device="cpu")
    c.meta_fit(n_iter=1, log_period=1, verbose=False)
    with pytest.raises(ValueError, match="same training step"):
        fit_models_parallel([GPRegressionMetaLearned(train, device="cpu"), c], n_iter=2,
                            prefer="vmap")
    with pytest.raises(NotImplementedError):
        fit_models_parallel([GPRegressionLearned(*train[0], device="cpu")], n_iter=2)


def _fused_group(n_iter=10):
    train = _tasks(n_tasks=4)
    return [GPRegressionMetaLearnedSVGD(train, num_iter_fit=n_iter, random_seed=s,
                                        num_particles=3, device="cpu", **SMALL)
            for s in (0, 1)]


@pytest.mark.parametrize("prefer", ["sequential_fused", "auto"])
def test_torch_sequential_fused_route_matches_meta_fit(prefer):
    """'sequential_fused' (and 'auto' for models all in a fused window) is
    per-model meta_fit: the same bits as fitting each model alone."""
    group = _fused_group()
    assert all(m._fused_path_ok() for m in group)
    fit_models_parallel(group, n_iter=10, prefer=prefer)
    for m_par, m_solo in zip(group, _fused_group()):
        m_solo.meta_fit(verbose=False, log_period=10)
        np.testing.assert_array_equal(m_par.particles.numpy(), m_solo.particles.numpy())


def test_torch_auto_route_stacks_outside_the_fused_window(monkeypatch):
    """'auto' stacks the general step where a model is outside every fused
    window (here all are, the fused kernels switched off), and
    'sequential_fused' refuses such a group."""
    monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")
    auto, stacked = _fused_group(), _fused_group()
    fit_models_parallel(auto, n_iter=5, prefer="auto")
    fit_models_parallel(stacked, n_iter=5, prefer="vmap")
    for a, b in zip(auto, stacked):
        np.testing.assert_array_equal(a.particles.numpy(), b.particles.numpy())
    with pytest.raises(ValueError, match="fused window"):
        fit_models_parallel(_fused_group(), n_iter=5, prefer="sequential_fused")


def _gp_case(seed, s=3, k=4, t=5, n=6):
    rs = np.random.RandomState(seed)
    cfg = random_gp_config(2, feature_dim=1, mean_nn_layers=(8, 8), kernel_nn_layers=(8, 8))
    prior = make_hyper_prior(cfg, weight_prior_std=0.5, bias_prior_std=3.0)
    particles = torch.tensor(rs.randn(s, k, prior.dim).astype(np.float32) * 0.5)
    X = torch.tensor(rs.randn(s, t, n, 2).astype(np.float32))
    Y = torch.tensor(rs.randn(s, t, n).astype(np.float32))
    mask = torch.ones(s, t, n)
    mask[:, 1, 4:] = 0.0
    counts = torch.tensor(rs.randint(0, 3, (s, t)).astype(np.float32))
    return prior, particles, X * mask[..., None], Y * mask, mask, counts


def test_torch_stacked_model_functions_match_single_calls():
    """meta_log_prob (full and count-weighted), gp_prior_mll_batch and
    neg_elbo on a seed axis (per-seed data, prior_factor [S]) against S
    single calls."""
    prior, particles, X, Y, mask, counts = _gp_case(0)
    pf = torch.tensor([0.01, 0.1, 1.0])
    mll = gp_prior_mll_batch(prior.cfg, prior.unravel(particles), X, Y, mask)
    got = meta_log_prob(prior, pf, particles, X, Y, mask)
    got_c = meta_log_prob(prior, pf, particles, X, Y, mask, counts=counts)
    gen = torch.Generator().manual_seed(1)
    posts = [init_posterior(gen, prior.dim) for _ in range(3)]
    eps = torch.randn(3, 2, prior.dim, generator=gen)
    post = {k: torch.stack([p[k] for p in posts]) for k in posts[0]}
    elbo = neg_elbo(prior, pf, post, eps, X, Y, mask, counts=counts)
    shared = meta_log_prob(prior, 0.1, particles, X[0], Y[0], mask[0])
    for i in range(3):
        torch.testing.assert_close(mll[i], gp_prior_mll_batch(
            prior.cfg, prior.unravel(particles[i]), X[i], Y[i], mask[i]), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got[i], meta_log_prob(
            prior, float(pf[i]), particles[i], X[i], Y[i], mask[i]), rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(got_c[i], meta_log_prob(
            prior, float(pf[i]), particles[i], X[i], Y[i], mask[i], counts=counts[i]),
            rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(elbo[i], neg_elbo(
            prior, float(pf[i]), posts[i], eps[i], X[i], Y[i], mask[i], counts=counts[i]),
            rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(shared[i], meta_log_prob(
            prior, 0.1, particles[i], X[0], Y[0], mask[0]), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("s,k,p", [(1, 10, 300), (3, 4, 64), (5, 10, 237), (4, 3, 1)])
def test_torch_svgd_seed_axis_matches_jax_vmap_and_single_calls(s, k, p):
    """K1's plain version on [S, K, P] (each system its own median at rank
    K*K//2) against the JAX package's Pallas Stein kernel under jax.vmap in
    interpret mode (its batching rule adds a grid axis), per system at rtol
    1e-5, and against S single [K, P] calls at rtol 1e-6 (batched products
    may sum in another order)."""
    rs = np.random.RandomState(s * 100 + k + p)
    x = rs.randn(s, k, p).astype(np.float32)
    score = (10.0 * rs.randn(s, k, p)).astype(np.float32)
    got = svgd_kernel.svgd_phi_ref(torch.tensor(x), torch.tensor(score)).numpy()
    want = np.asarray(jax.vmap(jax_svgd_phi)(jnp.asarray(x), jnp.asarray(score)))
    diff = np.abs(got - want).reshape(s, -1).max(axis=1)
    scale = np.abs(want).reshape(s, -1).max(axis=1)
    assert np.all(diff <= 1e-5 * scale), (diff / scale).max()
    singles = np.stack([
        svgd_kernel.svgd_phi_fused(torch.tensor(x[i]), torch.tensor(score[i])).numpy()
        for i in range(s)])
    diff = np.abs(got - singles).reshape(s, -1).max(axis=1)
    assert np.all(diff <= 1e-6 * scale), (diff / scale).max()


def test_torch_svgd_phi_numeric_bandwidth_per_system():
    """A numeric bandwidth per system ([S], the SVGD trials' case) on the RBF
    and IMQ transports against S single calls."""
    rs = np.random.RandomState(7)
    x = torch.tensor(rs.randn(3, 4, 20).astype(np.float32))
    score = torch.tensor(rs.randn(3, 4, 20).astype(np.float32))
    bw = torch.tensor([0.5, 1.0, 2.0])
    for kernel in ("RBF", "IMQ"):
        got = svgd_phi(x, score, kernel=kernel, bandwidth=bw)
        for i in range(3):
            torch.testing.assert_close(got[i], svgd_phi(x[i], score[i], kernel=kernel,
                                                        bandwidth=float(bw[i])),
                                       rtol=1e-6, atol=1e-6)
    got = svgd_phi(x, score, kernel="IMQ")
    for i in range(3):
        torch.testing.assert_close(got[i], svgd_phi(x[i], score[i], kernel="IMQ"),
                                   rtol=1e-6, atol=1e-6)
