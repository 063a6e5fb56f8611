"""The PyTorch port's modules against the JAX package's, on identical inputs.

Inputs come from numpy seeds and go to both packages. The JAX side runs its
CPU dispatch (plain XLA linear algebra); the port runs its CPU dispatch,
which takes each kernel's plain version. Tolerances are float32 ones, stated
per test; gradients are compared per system or particle, relative to its
largest entry.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from meta_learning_pacoh_tpu.models import gp_base as jax_gp_base
from meta_learning_pacoh_tpu.models import random_gp as jax_random_gp
from meta_learning_pacoh_tpu.ops import distributions as jax_dist
from meta_learning_pacoh_tpu.ops import gp as jax_gp
from meta_learning_pacoh_tpu.ops import metrics as jax_metrics
from meta_learning_pacoh_tpu.ops import svgd as jax_svgd
from meta_learning_pacoh_torch import GPRegressionMetaLearnedSVGD
from meta_learning_pacoh_torch.algos import pacoh_svgd
from meta_learning_pacoh_torch.models import gp_base, random_gp
from meta_learning_pacoh_torch.ops import distributions, gp, metrics, svgd


def assert_close_per_row(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    diff = np.abs(got - want).reshape(got.shape[0], -1).max(axis=1)
    scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1)
    assert np.all(diff <= rtol * scale), (diff / scale).max()


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rbf_systems(rs, b, n, m=0):
    """Joint RBF Gram of n (+ m) random 2-D points per system."""
    f = rs.randn(b, n + m, 2).astype(np.float32)
    d2 = ((f[:, :, None, :] - f[:, None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2).astype(np.float32)


@pytest.mark.parametrize("n", [5, 20, 56])
def test_gp_mll_batch_value_and_grads(n):
    """N=5 unrolled, N=20 the MLL kernel's plain version, N=56 the plain
    path; masks pad two systems. Values rtol 1e-5, gradients 1e-4."""
    rs = np.random.RandomState(n)
    b = 6
    K = _rbf_systems(rs, b, n)
    mean = rs.randn(b, n).astype(np.float32)
    y = rs.randn(b, n).astype(np.float32)
    noise = rs.uniform(0.05, 0.5, b).astype(np.float32)
    mask = np.ones((b, n), np.float32)
    mask[1, -2:] = 0.0
    mask[4, -1:] = 0.0

    def jax_fn(m_, k_, nv_):
        return jax_gp.gp_mll_batch(m_, k_, jnp.asarray(y), nv_, jnp.asarray(mask))

    args = (jnp.asarray(mean), jnp.asarray(K), jnp.asarray(noise))
    want = jax.jit(jax_fn)(*args)
    gm_j, gk_j, gn_j = jax.jit(jax.grad(
        lambda *a: jnp.sum(jax_fn(*a) * jnp.arange(1, b + 1)), argnums=(0, 1, 2)))(*args)
    m_t, k_t, n_t = (_t(a).requires_grad_(True) for a in (mean, K, noise))
    got = gp.gp_mll_batch(m_t, k_t, _t(y), n_t, _t(mask))
    torch.sum(got * torch.arange(1, b + 1)).backward()

    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    assert_close_per_row(m_t.grad.numpy(), np.asarray(gm_j), rtol=1e-4)
    sym = lambda g: 0.5 * (g + np.swapaxes(g, -1, -2))
    assert_close_per_row(sym(k_t.grad.numpy()), sym(np.asarray(gk_j)), rtol=1e-4)
    np.testing.assert_allclose(n_t.grad.numpy(), np.asarray(gn_j), rtol=1e-4)


@pytest.mark.parametrize("nc", [5, 20])
def test_gp_posterior(nc):
    """Posterior mean and covariance at 30 test points, rtol 1e-4 per system."""
    rs = np.random.RandomState(nc)
    b, nt = 4, 30
    K = _rbf_systems(rs, b, nc, nt)
    K_cc, K_ct, K_tt = K[:, :nc, :nc], K[:, :nc, nc:], K[:, nc:, nc:]
    mean_c, mean_t = rs.randn(b, nc).astype(np.float32), rs.randn(b, nt).astype(np.float32)
    y_c = rs.randn(b, nc).astype(np.float32)
    noise = rs.uniform(0.05, 0.5, b).astype(np.float32)
    mask = np.ones((b, nc), np.float32)
    mask[2, -1:] = 0.0

    want_m, want_c = jax.jit(jax.vmap(jax_gp.gp_posterior))(*map(jnp.asarray, (
        mean_c, K_cc, K_ct, mean_t, K_tt, y_c, noise, mask)))
    got_m, got_c = gp.gp_posterior(*map(_t, (mean_c, K_cc, K_ct, mean_t, K_tt, y_c)),
                                   _t(noise), mask_c=_t(mask))
    assert_close_per_row(got_m.numpy(), np.asarray(want_m), rtol=1e-4)
    assert_close_per_row(got_c.numpy(), np.asarray(want_c), rtol=1e-4)


def test_mvn_log_prob_with_relative_jitter():
    """N=70 (the Cholesky kernel's window); system 1 is indefinite by 0.5% of
    its scale, so both packages escalate it to the 1e-2 relative jitter.
    rtol 1e-4."""
    rs = np.random.RandomState(0)
    n = 70
    A = rs.randn(3, n, n + 3).astype(np.float32)
    cov = (A @ np.swapaxes(A, 1, 2) / n + 0.1 * np.eye(n)).astype(np.float32)
    lam = np.linalg.eigvalsh(cov[1].astype(np.float64))
    cov[1] -= ((lam[0] + 0.005 * np.mean(np.diag(cov[1]))) * np.eye(n)).astype(np.float32)
    y, mean = rs.randn(3, n).astype(np.float32), rs.randn(3, n).astype(np.float32)
    want = jax.jit(jax.vmap(jax_gp.mvn_log_prob))(*map(jnp.asarray, (y, mean, cov)))
    got = gp.mvn_log_prob(_t(y), _t(mean), _t(cov))
    assert np.all(np.isfinite(np.asarray(want)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


def _hyper_priors(n_hidden, mean_module="NN", covar_module="NN"):
    kw = dict(feature_dim=1, mean_nn_layers=(n_hidden,) * 2, kernel_nn_layers=(n_hidden,) * 2,
              mean_module=mean_module, covar_module=covar_module)
    jax_hp = jax_random_gp.make_hyper_prior(jax_random_gp.random_gp_config(2, **kw), 0.5, 3.0)
    hp = random_gp.make_hyper_prior(random_gp.random_gp_config(2, **kw), 0.5, 3.0)
    return jax_hp, hp


def test_flat_layout_matches_ravel_pytree():
    """Same P, same prior blocks, and every leaf unravels to the same numbers."""
    jax_hp, hp = _hyper_priors(32)
    assert hp.dim == jax_hp.dim == 2372
    np.testing.assert_array_equal(hp.loc.numpy(), jax_hp.loc)
    np.testing.assert_array_equal(hp.scale.numpy(), jax_hp.scale)
    flat = np.random.RandomState(0).randn(hp.dim).astype(np.float32)
    want = jax_hp.unravel(jnp.asarray(flat))
    got = hp.unravel(torch.from_numpy(flat))
    for block in ("kernel_nn", "mean_nn"):
        assert sorted(got[block]) == sorted(want[block])
        for leaf in want[block]:
            np.testing.assert_array_equal(got[block][leaf].numpy(),
                                          np.asarray(want[block][leaf]))
    for leaf in ("lengthscale_raw", "noise_raw"):
        np.testing.assert_array_equal(got[leaf].numpy(), np.asarray(want[leaf]))


@pytest.mark.parametrize("n,mean_module,covar_module",
                         [(5, "NN", "NN"), (12, "NN", "NN"), (12, "constant", "SE")])
def test_meta_log_prob_value_and_grad(n, mean_module, covar_module):
    """K=4 particles of width 8x8 on 3 tasks (one padded). Values rtol 1e-5,
    the score (gradient w.r.t. the particles) rtol 1e-4 per particle."""
    jax_hp, hp = _hyper_priors(8, mean_module, covar_module)
    assert hp.dim == jax_hp.dim
    np.testing.assert_array_equal(hp.loc.numpy(), jax_hp.loc)
    rs = np.random.RandomState(n)
    particles = (jax_hp.loc + jax_hp.scale * rs.randn(4, hp.dim)).astype(np.float32)
    X = rs.randn(3, n, 2).astype(np.float32)
    Y = rs.randn(3, n).astype(np.float32)
    mask = np.ones((3, n), np.float32)
    mask[2, -2:] = 0.0
    X[2, -2:] = 0.0
    Y[2, -2:] = 0.0

    def jax_fn(p):
        return jax_random_gp.meta_log_prob(jax_hp, 0.01, p, jnp.asarray(X), jnp.asarray(Y),
                                           jnp.asarray(mask))

    want = jax.jit(jax_fn)(jnp.asarray(particles))
    want_g = jax.jit(jax.grad(lambda p: jnp.sum(jax_fn(p))))(jnp.asarray(particles))
    p_t = _t(particles).requires_grad_(True)
    got = random_gp.meta_log_prob(hp, 0.01, p_t, _t(X), _t(Y), _t(mask))
    (got_g,) = torch.autograd.grad(got.sum(), p_t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    assert_close_per_row(got_g.numpy(), np.asarray(want_g), rtol=1e-4)


def test_mixture_eval_metrics():
    """K=4 components, 3 tasks of 30 points: LL and RMSE rtol 1e-5, calib equal
    to 1e-6 (a count over thresholds)."""
    rs = np.random.RandomState(1)
    k, t, n = 4, 3, 30
    means = rs.randn(k, t, n).astype(np.float32)
    A = rs.randn(k, t, n, n + 2).astype(np.float32)
    covs = (A @ np.swapaxes(A, -1, -2) / n + 0.2 * np.eye(n)).astype(np.float32)
    y = (2.0 + 3.0 * rs.randn(t, n)).astype(np.float32)
    want = jax.jit(jax.vmap(lambda m, c, yy: jax_metrics.mixture_eval_metrics(m, c, yy, 2.0, 3.0)))(
        jnp.asarray(np.swapaxes(means, 0, 1)), jnp.asarray(np.swapaxes(covs, 0, 1)),
        jnp.asarray(y))
    got = metrics.mixture_eval_metrics(_t(means), _t(covs), _t(y), 2.0, 3.0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-6)


@pytest.mark.parametrize("kernel,bandwidth", [("RBF", 0.7), ("IMQ", None), ("IMQ", 0.7)])
def test_svgd_phi_other_kernels(kernel, bandwidth):
    """The paths off the Stein kernel: fixed-bandwidth RBF and IMQ, rtol 1e-4."""
    rs = np.random.RandomState(3)
    x, s = rs.randn(6, 40).astype(np.float32), rs.randn(6, 40).astype(np.float32)
    want = jax_svgd.svgd_phi(jnp.asarray(x), jnp.asarray(s), kernel=kernel, bandwidth=bandwidth)
    got = svgd.svgd_phi(_t(x), _t(s), kernel=kernel, bandwidth=bandwidth)
    assert_close_per_row(got.numpy(), np.asarray(want), rtol=1e-4)


def test_adam_update_matches_optax_with_staircase(monkeypatch):
    """Seven Adam steps under lr_decay 0.5 with a 3-step staircase: the
    particles match optax.adam(exponential_decay(staircase=True)) to 1e-6,
    1e-4 of the step size (float32 rounding in another order)."""
    monkeypatch.setattr(pacoh_svgd, "LR_TRANSITION_STEPS", 3)
    rs = np.random.RandomState(0)
    tasks = [(rs.randn(4, 1), rs.randn(4, 1)) for _ in range(2)]
    model = GPRegressionMetaLearnedSVGD(tasks, num_particles=2, lr=1e-2, lr_decay=0.5,
                                        mean_nn_layers=(4,), kernel_nn_layers=(4,))
    params = model.particles.numpy().copy()
    opt = optax.adam(optax.exponential_decay(1e-2, transition_steps=3, decay_rate=0.5,
                                             staircase=True))
    state = opt.init(jnp.asarray(params))
    want = jnp.asarray(params)
    for _ in range(7):
        grad = rs.randn(*params.shape).astype(np.float32)
        updates, state = opt.update(jnp.asarray(grad), state, want)
        want = optax.apply_updates(want, updates)
        model._apply_update(_t(grad))
        model._step_count += 1
    np.testing.assert_allclose(model.particles.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_init_gp_params_tree_and_bounds():
    """The same tree and leaf shapes as the JAX init; kaiming-tanh draws
    inside their bounds."""
    cfg = random_gp.random_gp_config(2, feature_dim=1, mean_nn_layers=(8, 8),
                                     kernel_nn_layers=(8, 8))
    got = gp_base.init_gp_params(cfg, torch.Generator().manual_seed(0))
    want = jax_gp_base.init_gp_params(
        jax_random_gp.random_gp_config(2, feature_dim=1, mean_nn_layers=(8, 8),
                                       kernel_nn_layers=(8, 8)), jax.random.PRNGKey(0))
    assert sorted(got) == sorted(want)
    for block in ("mean_nn", "kernel_nn"):
        assert sorted(got[block]) == sorted(want[block])
        for name, leaf in got[block].items():
            assert tuple(leaf.shape) == want[block][name].shape
            fan_in, fan_out = (leaf.shape if leaf.dim() == 2 else (None, leaf.shape[0]))
            bound = (np.sqrt(3.0) * 5.0 / 3.0 / np.sqrt(fan_in) if name.startswith("w_")
                     else 1.0 / np.sqrt(fan_out))
            assert float(leaf.abs().max()) <= bound
    assert float(got["noise_raw"]) == 0.0 and tuple(got["lengthscale_raw"].shape) == (1,)


def test_predictive_distributions():
    """Mixture of affine-transformed joint Gaussians (what predict returns)
    and a mixture of Normals: mean, stddev, log_prob, cdf rtol 1e-5."""
    rs = np.random.RandomState(2)
    k, n = 3, 12
    means = rs.randn(k, n).astype(np.float32)
    A = rs.randn(k, n, n + 2).astype(np.float32)
    covs = (A @ np.swapaxes(A, -1, -2) / n + 0.3 * np.eye(n)).astype(np.float32)
    y = (1.5 + 2.0 * rs.randn(n)).astype(np.float32)

    got = distributions.EqualWeightedMixture(distributions.AffineTransformed(
        distributions.MultivariateNormal(_t(means), _t(covs)), 1.5, 2.0))
    want = jax_dist.EqualWeightedMixture(jax_dist.AffineTransformed(
        jax_dist.MultivariateNormal(jnp.asarray(means), jnp.asarray(covs)), 1.5, 2.0))
    for attr in ("mean", "stddev"):
        np.testing.assert_allclose(getattr(got, attr).numpy(), getattr(want, attr), rtol=1e-5)
    np.testing.assert_allclose(got.log_prob(_t(y)).numpy(), want.log_prob(jnp.asarray(y)),
                               rtol=1e-5)

    stds = np.sqrt(np.diagonal(covs, axis1=-2, axis2=-1))
    got_n = distributions.EqualWeightedMixture(distributions.Normal(_t(means), _t(stds)))
    want_n = jax_dist.EqualWeightedMixture(jax_dist.Normal(jnp.asarray(means), jnp.asarray(stds)))
    for attr in ("mean", "stddev"):
        np.testing.assert_allclose(getattr(got_n, attr).numpy(), getattr(want_n, attr), rtol=1e-5)
    for fn in ("log_prob", "cdf"):
        np.testing.assert_allclose(getattr(got_n, fn)(_t(y)).numpy(),
                                   getattr(want_n, fn)(jnp.asarray(y)), rtol=1e-5)
