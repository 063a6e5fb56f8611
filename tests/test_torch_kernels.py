"""The PyTorch port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper of meta_learning_pacoh_torch/ops/cuda takes its
plain PyTorch version; the JAX kernels run in Pallas interpret mode, as
the JAX package's own tests run them. Inputs come from numpy seeds and go
to both packages. Tolerances are float32 ones, stated per test; errors are
compared per system, relative to that system's largest value.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_gpu.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from meta_learning_pacoh_tpu.ops.pallas.blocked_mll_kernel import blocked_cholesky
from meta_learning_pacoh_tpu.ops.pallas.mll_kernel import mll_quad_logdet as jax_mll
from meta_learning_pacoh_tpu.ops.pallas.svgd_kernel import svgd_phi_fused as jax_svgd_phi
from meta_learning_pacoh_torch.ops.cuda import chol_kernel, mll_kernel, svgd_kernel
from meta_learning_pacoh_torch.ops.cuda.chol_kernel import cholesky_ref

P_SLICE = 2372  # particle width of the cauchy_20 slice (NN 32x32 mean + kernel, D=2)


def assert_close_per_system(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    diff = np.abs(got - want).reshape(got.shape[0], -1).max(axis=1)
    scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1)
    assert np.all(diff <= rtol * scale), (diff / scale).max()


def _psd(b, n, seed, scale=0.5):
    rs = np.random.RandomState(seed)
    A = rs.randn(b, n + 3, n).astype(np.float32)
    return (np.einsum("bin,bim->bnm", A, A) / n
            + scale * np.eye(n, dtype=np.float32)).astype(np.float32)


def _escalating(n, lam_min, rs):
    """Symmetric, eigenvalues in [1e-4, 1e-3] but one at lam_min < 0: the
    factorization fails at jitter 0 and succeeds at the first jitter above
    -lam_min, with a condition number below 30."""
    q, _ = np.linalg.qr(rs.randn(n, n))
    lam = rs.uniform(1e-4, 1e-3, n)
    lam[0] = lam_min
    return ((q * lam) @ q.T).astype(np.float32)


def _mll_systems(n, seed):
    rs = np.random.RandomState(seed)
    kn = _psd(12, n, seed)
    kn[2] = _escalating(n, -5e-5, rs)  # needs the 1e-4 jitter
    kn[5] = _escalating(n, -5e-3, rs)  # needs the 1e-2 jitter
    r = rs.randn(12, n).astype(np.float32)
    return kn, r


# ------------------------------------------------------------- Stein kernel

def _phi_with_median(x, s, median):
    k = x.shape[0]
    gamma = 1.0 / (1e-8 + 2.0 * median / (2.0 * np.log(k + 1)))
    k_xx = torch.exp(-gamma * svgd_kernel.sq_dists(x, x))
    return (k_xx @ s + 2 * gamma * (x * k_xx.sum(1, keepdim=True) - k_xx @ x)) / k


@pytest.mark.parametrize("k", [4, 10])
def test_svgd_phi_plain_matches_pallas_kernel(k):
    """rtol 1e-5 relative to the largest |phi|: float32 sums in another order
    (3e-7 measured). Taking the lower middle or the mean of the two middles
    as the median misses by more than 2e-4, so the test pins rank K*K//2."""
    rs = np.random.RandomState(k)
    x = rs.randn(k, P_SLICE).astype(np.float32)
    s = (10.0 * rs.randn(k, P_SLICE)).astype(np.float32)
    want = np.asarray(jax_svgd_phi(jnp.asarray(x), jnp.asarray(s)))
    xt, st = torch.from_numpy(x), torch.from_numpy(s)
    got = svgd_kernel.svgd_phi_fused(xt, st).numpy()
    assert_close_per_system(got[None], want[None], rtol=1e-5)

    ordered = torch.sort(svgd_kernel.sq_dists(xt, xt).reshape(-1)).values
    lower, upper = ordered[k * k // 2 - 1], ordered[k * k // 2]
    for median in (lower, 0.5 * (lower + upper)):
        other = _phi_with_median(xt, st, median).numpy()
        assert np.abs(other - want).max() > 10 * 1e-5 * np.abs(want).max()


# --------------------------------------------------------------- MLL kernel

@pytest.mark.parametrize("n", [9, 20])
def test_mll_plain_matches_pallas_kernel_values_and_grads(n):
    """quad, logdet and the gradients w.r.t. kn and r, with systems 2 and 5
    escalated to the 1e-4 and the 1e-2 jitter. rtol 1e-4 per system."""
    kn, r = _mll_systems(n, seed=n)
    wq = np.random.RandomState(1).randn(12).astype(np.float32)
    wl = np.random.RandomState(2).randn(12).astype(np.float32)

    def jax_loss(k_, r_):
        q, l = jax_mll(k_, r_)
        return jnp.sum(wq * q + wl * l), (q, l)

    (_, (q_j, l_j)), (gk_j, gr_j) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(kn), jnp.asarray(r))

    kn_t = torch.from_numpy(kn).requires_grad_(True)
    r_t = torch.from_numpy(r).requires_grad_(True)
    q_t, l_t = mll_kernel.mll_quad_logdet(kn_t, r_t)
    torch.sum(torch.from_numpy(wq) * q_t + torch.from_numpy(wl) * l_t).backward()

    np.testing.assert_allclose(q_t.detach().numpy(), np.asarray(q_j), rtol=1e-4)
    np.testing.assert_allclose(l_t.detach().numpy(), np.asarray(l_j), rtol=1e-4, atol=1e-4)
    assert_close_per_system(kn_t.grad.numpy(), np.asarray(gk_j), rtol=1e-4)
    assert_close_per_system(r_t.grad.numpy(), np.asarray(gr_j), rtol=1e-4)


def test_mll_escalation_levels_are_the_ones_intended():
    kn, _ = _mll_systems(20, seed=20)
    kn_t = torch.from_numpy(kn)
    eye = torch.eye(20)
    ok = [chol_kernel.diag_ok(cholesky_ref(kn_t + j * eye)) for j in mll_kernel.JITTERS]
    level = torch.where(ok[0], 0, torch.where(ok[1], 1, 2))
    assert level[2] == 1 and level[5] == 2
    assert int((level == 0).sum()) == 10


# ---------------------------------------------------------- Cholesky kernel

@pytest.mark.parametrize("n", [70, 200])
def test_cholesky_plain_matches_pallas_kernel(n):
    """Lower factor, rtol 2e-5 per matrix; only the lower triangle is read."""
    a = _psd(3, n, seed=n)
    want = np.asarray(blocked_cholesky(jnp.asarray(a)))
    upper_noise = np.triu(np.random.RandomState(0).randn(n, n), 1).astype(np.float32)
    got = chol_kernel.cholesky_fused(torch.from_numpy(a + upper_noise)).numpy()
    assert_close_per_system(got, want, rtol=2e-5)


def test_cholesky_failure_is_nan_as_in_pallas_kernel():
    """An indefinite matrix gives a NaN diagonal in both; its neighbours in
    the batch are untouched."""
    a = _psd(3, 70, seed=3)
    a[1] -= 10.0 * np.eye(70, dtype=np.float32)
    want = np.asarray(blocked_cholesky(jnp.asarray(a)))
    got = chol_kernel.cholesky_fused(torch.from_numpy(a)).numpy()
    assert np.isnan(np.diagonal(want[1])).all() and np.isnan(got[1]).all()
    assert_close_per_system(got[[0, 2]], want[[0, 2]], rtol=2e-5)
