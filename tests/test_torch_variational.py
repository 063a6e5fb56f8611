"""The port's variational building blocks (ops/variational.py) against the JAX package's.

``gaussian_kl_chol`` (value, and its closed-form backward against
``jax.grad`` of the JAX function's custom VJP) at N=5, where both take the
unrolled factorization, and at N=40, where both take ``safe_cholesky`` and
triangular solves; a system that needs the 1e-4 jitter picks the same level
in both. ``svgp_predict`` and ``expected_log_prob_gaussian`` on the same
numpy inputs. Tolerances: values rtol 1e-5, gradients and predictive
moments 1e-4 of their largest entry (float32 factorizations in two orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_learning_pacoh_tpu.ops import variational as jax_var
from meta_learning_pacoh_torch.ops import variational


def _spd(rs, b, n, shift=0.1):
    a = rs.randn(b, n, n + 2)
    return (a @ a.transpose(0, 2, 1) / n + shift * np.eye(n)).astype(np.float32)


def _escalating(rs, n, lam_min):
    """A symmetric matrix with eigenvalues in [1e-4, 1e-3] but one lam_min."""
    q, _ = np.linalg.qr(rs.randn(n, n))
    lam = rs.uniform(1e-4, 1e-3, n)
    lam[0] = lam_min
    return ((q * lam) @ q.T).astype(np.float32)


def _kl_inputs(n, escalate, b=3):
    rs = np.random.RandomState(n)
    m0 = rs.randn(b, n).astype(np.float32)
    m1 = rs.randn(b, n).astype(np.float32)
    K1 = _spd(rs, b, n)
    if escalate:  # needs the 1e-4 jitter (-5e-5), a healthy one beside it
        K1[1] = _escalating(rs, n, -5e-5)
    L0 = (np.tril(0.1 * rs.randn(b, n, n)) + np.eye(n)).astype(np.float32)
    return m0, L0, m1, K1


@pytest.mark.parametrize("escalate", [False, True])
@pytest.mark.parametrize("n", [5, 40])
def test_gaussian_kl_value_and_gradients_match_jax(n, escalate):
    inputs = _kl_inputs(n, escalate)
    weights = np.arange(1.0, 4.0, dtype=np.float32)

    def jax_total(*args):
        return jnp.sum(jax.vmap(jax_var.gaussian_kl_chol)(*args) * weights)

    kl_j = np.asarray(jax.vmap(jax_var.gaussian_kl_chol)(*inputs))
    grads_j = jax.grad(jax_total, argnums=(0, 1, 2, 3))(*inputs)
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    kl = variational.gaussian_kl_chol(*ts)
    grads = torch.autograd.grad(torch.sum(kl * torch.from_numpy(weights)), ts)
    np.testing.assert_allclose(kl.detach().numpy(), kl_j, rtol=1e-5)
    for got, want in zip(grads, grads_j):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_gaussian_kl_broadcasts_a_shared_posterior():
    """One posterior against S priors, as the learner calls it: the same
    values as the expanded inputs, and the gradient summed over S."""
    m0, L0, m1, K1 = _kl_inputs(5, False)
    m0_t = torch.tensor(m0[0], requires_grad=True)
    kl = variational.gaussian_kl_chol(m0_t, torch.tensor(L0[0]), torch.tensor(m1),
                                      torch.tensor(K1))
    (g,) = torch.autograd.grad(kl.sum(), m0_t)
    expanded = torch.tensor(np.repeat(m0[:1], 3, axis=0), requires_grad=True)
    kl_e = variational.gaussian_kl_chol(expanded, torch.tensor(np.repeat(L0[:1], 3, axis=0)),
                                        torch.tensor(m1), torch.tensor(K1))
    (g_e,) = torch.autograd.grad(kl_e.sum(), expanded)
    np.testing.assert_array_equal(kl.detach().numpy(), kl_e.detach().numpy())
    np.testing.assert_allclose(g.numpy(), g_e.sum(0).numpy(), rtol=1e-6)


@pytest.mark.parametrize("nc", [5, 40])
def test_svgp_predict_matches_jax(nc):
    rs = np.random.RandomState(nc + 1)
    nt = 7
    K = _spd(rs, 3, nc + nt, shift=0.2)
    mean = rs.randn(3, nc + nt).astype(np.float32)
    q_mean = rs.randn(3, nc).astype(np.float32)
    q_chol = (np.tril(0.1 * rs.randn(3, nc, nc)) + 0.5 * np.eye(nc)).astype(np.float32)
    args = (q_mean, q_chol, mean[:, :nc], K[:, :nc, :nc], K[:, :nc, nc:], mean[:, nc:],
            K[:, nc:, nc:])
    m_j, c_j = (np.asarray(a) for a in jax.vmap(jax_var.svgp_predict)(*args))
    m, c = variational.svgp_predict(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(m.numpy(), m_j, rtol=0, atol=1e-4 * np.abs(m_j).max())
    np.testing.assert_allclose(c.numpy(), c_j, rtol=0, atol=1e-4 * np.abs(c_j).max())


def test_expected_log_prob_matches_jax():
    rs = np.random.RandomState(3)
    y, f_mean = rs.randn(2, 4, 6).astype(np.float32)
    f_var = rs.uniform(0.1, 1.0, (4, 6)).astype(np.float32)
    want = jax_var.expected_log_prob_gaussian(y, f_mean, f_var, jnp.float32(0.3))
    got = variational.expected_log_prob_gaussian(
        torch.from_numpy(y), torch.from_numpy(f_mean), torch.from_numpy(f_var),
        torch.tensor(0.3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
