"""K2, the small-N MLL forward as one warp a system, on the CPU.

The CUDA kernel (csrc/mll.cu) runs only on the card; here its schedule is
emulated in numpy: the right-looking factorization a column at a time
(pivot, 1/sqrt scaling, trailing update) with r carried as the border row,
so z_j comes out as column j completes, and the jitter escalated per system
through (0, 1e-4, 1e-2), the last level taken regardless. A pivot below
float32's smallest normal counts as failed, as the kernel's flushing
reciprocal square root makes it. The float32 emulation is held against the JAX package's
Pallas kernel in interpret mode for quad, logdet and z (rtol 1e-4, as
tests/test_torch_kernels.py holds the plain version), and its L against
numpy's float64 Cholesky at the same jitter. N=64 is beyond the JAX
kernel's window (9 <= N <= 48), so there the emulation is held against the
port's plain version.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from meta_learning_pacoh_tpu.ops.pallas.mll_kernel import _mll_fwd_call as jax_mll_fwd
from meta_learning_pacoh_torch.ops.cuda import mll_kernel

FAILS = 9  # the system indefinite at every jitter level


def assert_close_per_system(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    diff = np.abs(got - want).reshape(got.shape[0], -1).max(axis=1)
    scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1)
    assert np.all(diff <= rtol * scale), (diff / scale).max()


def _escalating(n, lam_min, rs):
    """Symmetric, eigenvalues in [1e-4, 1e-3] but one at lam_min < 0: the
    factorization fails at jitter 0 and succeeds at the first jitter above
    -lam_min."""
    q, _ = np.linalg.qr(rs.randn(n, n))
    lam = rs.uniform(1e-4, 1e-3, n)
    lam[0] = lam_min
    return ((q * lam) @ q.T).astype(np.float32)


def systems(n, seed):
    """12 systems: 2 needs the 1e-4 jitter, 5 the 1e-2 jitter, FAILS fails
    at every level; the others factor at once."""
    rs = np.random.RandomState(seed)
    a = rs.randn(12, n + 3, n).astype(np.float32)
    kn = np.einsum("bin,bim->bnm", a, a) / n + 0.5 * np.eye(n, dtype=np.float32)
    kn = kn.astype(np.float32)
    kn[2] = _escalating(n, -5e-5, rs)
    kn[5] = _escalating(n, -5e-3, rs)
    kn[FAILS] -= 10.0 * np.eye(n, dtype=np.float32)
    return kn, rs.randn(12, n).astype(np.float32)


def emulate_mll_fwd(kn, r):
    """K2's schedule in float32, a system at a time: (quad, logdet, L, z,
    the jitter level taken)."""
    f = np.float32
    b, n = kn.shape[0], kn.shape[-1]
    quad, logdet = np.zeros(b, f), np.zeros(b, f)
    L_out, z_out, levels = np.zeros((b, n, n), f), np.zeros((b, n), f), np.zeros(b, int)
    with np.errstate(invalid="ignore", divide="ignore"):
        for m in range(b):
            for level, jit in enumerate(mll_kernel.JITTERS):
                a = np.tril(kn[m] + f(jit) * np.eye(n, dtype=f)).astype(f)
                w = r[m].astype(f).copy()
                L = np.zeros((n, n), f)
                ok = True
                for j in range(n):
                    d = a[j, j]
                    if not (d >= np.finfo(f).tiny and np.isfinite(d)):
                        ok = False
                        if level < 2:
                            break
                    inv = f(1) / np.sqrt(d)
                    zj = w[j] * inv
                    col = a[j + 1:, j] * inv  # L[j+1:, j]
                    w[j + 1:] -= col * zj  # the border row
                    a[j + 1:, j + 1:] -= np.tril(np.outer(col, col)).astype(f)
                    L[j, j], L[j + 1:, j], w[j] = np.sqrt(d), col, zj
                if ok or level == 2:
                    break
            levels[m] = level
            quad[m] = np.sum(w * w, dtype=f)
            logdet[m] = f(2) * np.sum(np.log(np.diagonal(L)), dtype=f)
            L_out[m], z_out[m] = L, w
    return quad, logdet, L_out, z_out, levels


@pytest.mark.parametrize("n", [9, 20, 32, 33, 48])
def test_warp_schedule_matches_pallas_kernel(n):
    """quad, logdet and z of the emulation against the Pallas kernel in
    interpret mode, rtol 1e-4 per system; systems 2 and 5 at escalation
    levels 1 and 2; the system failing every level non-finite in both. L
    against numpy's float64 Cholesky at the level taken."""
    kn, r = systems(n, seed=n)
    quad, logdet, L, z, levels = emulate_mll_fwd(kn, r)
    assert levels[2] == 1 and levels[5] == 2 and levels[FAILS] == 2
    assert int((levels == 0).sum()) == 9
    q_j, l_j, _, z_j = (np.asarray(t) for t in jax_mll_fwd(jnp.asarray(kn), jnp.asarray(r),
                                                            interpret=True))
    q_j, l_j = q_j[:, 0], l_j[:, 0]
    for got, want in ((quad, q_j), (logdet, l_j)):
        assert not np.isfinite(got[FAILS]) and not np.isfinite(want[FAILS])
    keep = np.arange(12) != FAILS
    np.testing.assert_allclose(quad[keep], q_j[keep], rtol=1e-4)
    np.testing.assert_allclose(logdet[keep], l_j[keep], rtol=1e-4, atol=1e-4)
    assert_close_per_system(z[keep], z_j[keep], rtol=1e-4)
    jit = np.array(mll_kernel.JITTERS)[levels[keep]]
    want_L = np.linalg.cholesky(kn[keep].astype(np.float64) + jit[:, None, None] * np.eye(n))
    assert_close_per_system(L[keep], want_L, rtol=1e-4)
    assert np.all(np.triu(L[keep], 1) == 0)


def test_warp_schedule_at_n64_matches_plain():
    """N=64, the wider register instance's edge (beyond the JAX kernel's
    window): the emulation against the port's plain version, rtol 1e-4 per
    system; the failing system non-finite in both."""
    kn, r = systems(64, seed=64)
    quad, logdet, L, z, levels = emulate_mll_fwd(kn, r)
    want = [t.numpy() for t in mll_kernel.mll_fwd_ref(torch.from_numpy(kn), torch.from_numpy(r))]
    assert levels[2] == 1 and levels[5] == 2
    keep = np.arange(12) != FAILS
    for got, ref in zip((quad, logdet, L, z), want):
        assert_close_per_system(got[keep].reshape(11, -1), ref[keep].reshape(11, -1), rtol=1e-4)
    for got, ref in zip((quad, logdet), want[:2]):
        assert not np.isfinite(got[FAILS]) and not np.isfinite(ref[FAILS])


@pytest.mark.parametrize("n", [9, 20, 33, 48])
def test_denormal_pivots_escalate_as_in_pallas_kernel(n):
    """A system scaled into float32's denormals (pivots below 2^-126) fails
    its first level, as a zero pivot does, and takes the 1e-4 jitter: its
    quad, logdet and z against the Pallas kernel in interpret mode (which
    flushes denormals too), rtol 1e-4 per system, beside three systems of
    ``systems``."""
    kn, r = systems(n, seed=n)
    kn, r = kn[:4].copy(), r[:4].copy()
    kn[1] = kn[1] * np.float32(1e-39)
    assert 0 < abs(kn[1][0, 0]) < np.finfo(np.float32).tiny
    quad, logdet, L, z, levels = emulate_mll_fwd(kn, r)
    assert list(levels) == [0, 1, 1, 0]  # system 2 escalates as in systems()
    q_j, l_j, _, z_j = (np.asarray(t) for t in jax_mll_fwd(jnp.asarray(kn), jnp.asarray(r),
                                                            interpret=True))
    assert np.all(np.isfinite(quad)) and np.all(np.isfinite(logdet))
    np.testing.assert_allclose(quad, q_j[:, 0], rtol=1e-4)
    np.testing.assert_allclose(logdet, l_j[:, 0], rtol=1e-4, atol=1e-4)
    assert_close_per_system(z, z_j, rtol=1e-4)
