"""The small-matrix Cholesky B5 (ops/cuda/chol_small_kernel.py) on the CPU,
against the JAX package's Pallas kernel ``cholesky_pallas`` run in
interpret mode, as tests/test_chol.py runs it.

The wrapper takes its plain version for a CPU tensor (the CUDA kernel is
held against it on the card: tests/test_torch_gpu.py, chip_smoke.py phase
2). The kernel's schedule, the register factorization it shares with K2
(csrc/warp_chol.cuh) without border row or jitter, any finite positive
pivot taken, is emulated in float32 (``factor_columns`` of
tests/test_torch_mll_warp.py). Tolerance: per matrix, 2e-4 of its largest
factor entry (two float32 factorization orders). ``ops.chol`` sends
32 <= N <= 64 to B5 and 65 <= N <= 512 to K4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_learning_pacoh_tpu.ops.pallas import chol_kernel as jax_chol
from meta_learning_pacoh_torch.ops import chol
from meta_learning_pacoh_torch.ops.cuda import chol_small_kernel
from test_torch_mll_warp import factor_columns, normal_pivot, positive_pivot


def _spd(b, n, seed):
    rs = np.random.RandomState(seed)
    a = rs.randn(b, n, n + 2)
    return (a @ a.transpose(0, 2, 1) / n + 0.1 * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("b", [1, 3, 130])
@pytest.mark.parametrize("n", [32, 50, 64])
def test_plain_version_matches_pallas_kernel(n, b):
    """B matrices through the lane-parallel TPU kernel (and one 2-D matrix
    through the single-matrix one at B=1)."""
    a = _spd(b, n, seed=n + b)
    want = np.asarray(jax_chol.cholesky_pallas(jnp.asarray(a[0] if b == 1 else a)))
    want = want.reshape(b, n, n)
    got = chol_small_kernel.cholesky_small(torch.from_numpy(a)).numpy()
    scale = np.abs(want).reshape(b, -1).max(axis=1)
    err = np.abs(got - want).reshape(b, -1).max(axis=1) / scale
    assert err.max() <= 2e-4, err.max()
    np.testing.assert_array_equal(np.triu(got, 1), 0.0)


def emulate_chol_small(a):
    """B5's schedule in float32, a matrix at a time: the lower factor, or
    all NaN where a pivot is not finite and positive."""
    out = np.empty_like(a)
    for m in range(a.shape[0]):
        L, _, ok = factor_columns(a[m], None, positive_pivot)
        out[m] = L if ok else np.nan
    return out


def _per_matrix_err(got, want):
    scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1)
    return (np.abs(got - want).reshape(got.shape[0], -1).max(axis=1) / scale).max()


def _denormal_pivots(a, m):
    """Matrix m with pivots 0 and 17 at 1e-39, below float32's smallest
    normal, their rows and columns zero elsewhere."""
    for k in (0, 17):
        a[m, k, :] = 0.0
        a[m, :, k] = 0.0
        a[m, k, k] = np.float32(1e-39)
    assert 0 < a[m, 17, 17] < np.finfo(np.float32).tiny
    return a


@pytest.mark.parametrize("n", [32, 50, 64])
def test_warp_schedule_matches_pallas_kernel(n):
    """B5's schedule against the lane-parallel Pallas kernel in interpret
    mode on 5 matrices, 2e-4 per matrix, zeros above the diagonal."""
    a = _spd(5, n, seed=200 + n)
    got = emulate_chol_small(a)
    want = np.asarray(jax_chol.cholesky_pallas(jnp.asarray(a)))
    assert _per_matrix_err(got, want) <= 2e-4
    np.testing.assert_array_equal(np.triu(got, 1), 0.0)


@pytest.mark.parametrize("n", [32, 50, 64])
def test_warp_schedule_factors_a_denormal_pivot(n):
    """A pivot in (0, 2^-126) is factored, as the plain version (LAPACK's
    cholesky_ex) factors it, to 2e-4 per matrix; K2's pivot rule (at least
    the smallest normal) would have failed it. The Pallas kernel is no
    reference here: the CPU backend flushes denormals to 0."""
    a = _denormal_pivots(_spd(3, n, seed=300 + n), 1)
    got = emulate_chol_small(a)
    want = chol_small_kernel.cholesky_small(torch.from_numpy(a)).numpy()
    assert np.all(np.isfinite(got)) and np.all(np.isfinite(want))
    assert _per_matrix_err(got, want) <= 2e-4
    np.testing.assert_allclose(got[1, 17, 17], np.sqrt(np.float64(a[1, 17, 17])), rtol=1e-6)
    assert not factor_columns(a[1], None, normal_pivot)[2]


def test_warp_schedule_indefinite_is_all_nan():
    """An indefinite matrix among four: all NaN, as in the plain version;
    its neighbours factored to 2e-4 per matrix."""
    a = _spd(4, 40, seed=1)
    lam = np.linalg.eigvalsh(a[2].astype(np.float64))
    a[2] -= np.float32(lam[0] + 1e-2) * np.eye(40, dtype=np.float32)
    got = emulate_chol_small(a)
    want = chol_small_kernel.cholesky_small(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[2]).all()
    assert _per_matrix_err(got[[0, 1, 3]], want[[0, 1, 3]]) <= 2e-4


def test_failed_factorization_is_all_nan():
    a = _spd(4, 40, seed=1)
    lam = np.linalg.eigvalsh(a[2].astype(np.float64))
    a[2] -= np.float32(lam[0] + 1e-2) * np.eye(40, dtype=np.float32)
    got = chol_small_kernel.cholesky_small(torch.from_numpy(a))
    assert torch.isnan(got[2]).all() and not torch.isnan(got[[0, 1, 3]]).any()


@pytest.mark.parametrize("n, route", [(31, None), (32, "small"), (50, "small"), (64, "small"),
                                      (65, "k4"), (512, "k4"), (513, None)])
def test_dispatch_window(monkeypatch, n, route):
    """With the kernels on, N in 32-64 goes to B5 and 65-512 to K4, both
    called with [B, N, N]; otherwise the plain version."""
    monkeypatch.delenv("PACOH_TORCH_DISABLE_KERNELS", raising=False)
    calls = []
    for name, label in (("cholesky_small", "small"), ("cholesky_fused", "k4")):
        fn = getattr(chol, name)
        monkeypatch.setattr(chol, name, lambda a, fn=fn, label=label: calls.append(
            (label, tuple(a.shape))) or fn(a))
    a = torch.from_numpy(_spd(2, n, seed=n)).reshape(1, 2, n, n)
    L = chol._cholesky_impl(a)
    assert L.shape == a.shape and torch.isfinite(L).all()
    assert calls == ([] if route is None else [(route, (2, n, n))])
    monkeypatch.setenv("PACOH_TORCH_DISABLE_KERNELS", "1")
    calls.clear()
    chol._cholesky_impl(a)
    assert calls == []


def test_safe_cholesky_escalates_through_the_window():
    """safe_cholesky at N=50 reaches B5 through _cholesky_impl and escalates
    per matrix as before."""
    a = torch.from_numpy(_spd(3, 50, seed=7))
    lam = torch.linalg.eigvalsh(a[1].double())
    a[1] -= float(lam[0] + 5e-5) * torch.eye(50)
    L = chol.safe_cholesky(a)
    assert torch.isfinite(L).all()
    torch.testing.assert_close(L[0], torch.linalg.cholesky(a[0] + 1e-6 * torch.eye(50)))
