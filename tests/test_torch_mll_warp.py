"""The one-warp small-N kernels of csrc/mll.cu on the CPU: K2, the MLL
forward, and K3, its backward.

The CUDA kernels run only on the card; here their schedules are emulated in
numpy. K2: the right-looking factorization a column at a time (pivot,
1/sqrt scaling, trailing update; ``factor_columns``, the arithmetic of
csrc/warp_chol.cuh, which B5 shares: tests/test_torch_chol_small.py) with r
carried as the border row, so z_j comes out as column j completes, and the
jitter escalated per system through (0, 1e-4, 1e-2), the last level taken
regardless. A pivot below float32's smallest normal counts as failed, as
the kernel's flushing reciprocal square root makes it. The float32
emulation is held against the JAX package's Pallas kernel in interpret
mode for quad, logdet and z (rtol 1e-4, as tests/test_torch_kernels.py
holds the plain version), and its L against numpy's float64 Cholesky at
the same jitter. K3: W = L^-1 a column a lane by the right-looking sweep
over a sliding window, alpha = W^T z, K^-1 = W^T W from the W^T tile, in
the kernel's own layout (tiles at its leading dimension, float4 groups and
their guards; what the kernel never writes is NaN here, so a read of it
shows), held against the Pallas backward in interpret mode (rtol 1e-4 per
system). N=64 is beyond the JAX kernels' window (9 <= N <= 48), so there
the emulations are held against the port's plain versions.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from meta_learning_pacoh_tpu.ops.pallas.mll_kernel import _mll_bwd_call as jax_mll_bwd
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


def normal_pivot(d):
    """K2's pivot test: finite and at least float32's smallest normal."""
    return bool(d >= np.finfo(np.float32).tiny and np.isfinite(d))


def positive_pivot(d):
    """B5's pivot test: finite and positive, a denormal pivot too."""
    return bool(d > 0 and np.isfinite(d))


def factor_columns(a, w, pivot_ok, stop=True):
    """The register factorization (csrc/warp_chol.cuh's factor_rows) in
    float32 on one system a [N, N], its lower triangle read: per column j
    the pivot d, inv = 1/sqrt(d), the column scaled by inv, the diagonal
    d * inv, the trailing update; w, where not None, is the border row,
    carried through the same updates. Returns (L, w, ok); ``stop`` ends at
    the first pivot that fails ``pivot_ok``."""
    f = np.float32
    n = a.shape[-1]
    a = np.tril(a).astype(f)
    w = None if w is None else w.astype(f).copy()
    L = np.zeros((n, n), f)
    ok = True
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for j in range(n):
            d = a[j, j]
            if not pivot_ok(d):
                ok = False
                if stop:
                    break
            inv = f(1) / np.sqrt(d)
            col = a[j + 1:, j] * inv  # L[j+1:, j]
            if w is not None:
                zj = w[j] * inv
                w[j + 1:] -= col * zj
                w[j] = zj
            a[j + 1:, j + 1:] -= np.tril(np.outer(col, col)).astype(f)
            L[j, j], L[j + 1:, j] = d * inv, col
    return L, w, ok


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
                L, w, ok = factor_columns(kn[m] + f(jit) * np.eye(n, dtype=f), r[m], normal_pivot,
                                          stop=level < 2)
                if ok or level == 2:
                    break
            levels[m] = level
            quad[m] = np.sum(w * w, dtype=f)
            logdet[m] = f(2) * np.sum(np.log(np.diagonal(L)), dtype=f)
            L_out[m], z_out[m] = L, w
    return quad, logdet, L_out, z_out, levels


def bwd_ld(n):
    """K3's tile leading dimension (csrc/mll.cu's bwd_ld): N rounded up to
    4, four times an odd number."""
    return 4 * (((n + 3) // 4) | 1)


def _load4(tile, row, col, take):
    """One float4 read of a tile, or zeros where the kernel predicates it off."""
    return tile[row, col:col + 4] if take else np.zeros(4, np.float32)


def _sweep_columns(w, lt, dinv, wt, j_begin, j_end, n, span):
    """csrc/mll.cu's sweep_columns on every lane at once: w [C, 32, S] holds
    lane c's columns c + 32 q, rows j0 .. j0 + S - 1 (the window); ``span``
    rows are read under one uniform guard."""
    f = np.float32
    lanes = np.arange(32)
    n_cols, _, s = w.shape
    for j0 in range(j_begin, j_end, 4):
        for u in range(4):
            j = j0 + u
            if j >= n:
                continue
            w[:, :, u] *= dinv[j]
            for k1 in range(0, s, span):
                if not (k1 + span - 1 > u and j0 + k1 < n):
                    continue
                for k0 in range(k1, k1 + span, 4):
                    l4 = _load4(lt, j, j0 + k0, k0 + 3 > u and j0 + k0 < n)
                    for e in range(4):
                        if k0 + e > u:
                            w[:, :, k0 + e] -= f(l4[e]) * w[:, :, u]
        for q in range(n_cols):
            rows = lanes + 32 * q
            mine = rows < n
            wt[rows[mine], j0:j0 + 4] = w[q, mine, 0:4]
        w[:, :, :s - 4] = w[:, :, 4:].copy()
        w[:, :, s - 4:] = 0


def emulate_mll_bwd(L, z, gq, gl):
    """K3's schedule in float32, a system at a time, in the kernel's layout:
    (dKn, dr)."""
    f = np.float32
    b, n = L.shape[0], L.shape[-1]
    R = 1 if n <= 32 else 2
    span = 16 * R  # rows a loop reads under one uniform guard
    ld = bwd_ld(n)
    lanes = np.arange(32)
    dkn, dr = np.zeros((b, n, n), f), np.zeros((b, n), f)
    with np.errstate(invalid="ignore", over="ignore"):
        for m in range(b):
            # L^T: lt[c, i] = L[i, c] for c <= i, 0 for the rows beyond N;
            # NaN where the kernel leaves it unwritten or never reads it
            lt = np.full((n, ld), np.nan, f)
            lt[:, :(n + 3) // 4 * 4] = 0
            lt[:, :n] = np.where(np.tril(np.ones((n, n), bool)).T, L[m].T, np.nan)
            zs, dinv = np.zeros(ld, f), np.zeros(ld, f)
            zs[:n] = z[m]
            dinv[:n] = f(1) / np.diagonal(L[m]).astype(f)
            wt = np.full((n, ld), np.nan, f)  # W^T: what the sweep writes
            if R == 1:
                w = (np.arange(32)[None, None, :] == lanes[None, :, None]).astype(f)
                _sweep_columns(w, lt, dinv, wt, 0, n, n, span)
            else:
                wa = (np.arange(64)[None, None, :] == lanes[None, :, None]).astype(f)
                _sweep_columns(wa, lt, dinv, wt, 0, 32, n, span)
                wb = np.stack([wa[0, :, :32], np.eye(32, dtype=f)])
                _sweep_columns(wb, lt, dinv, wt, 32, n, n, span)
            own = np.zeros((R, 32, 32 * R), f)
            al = np.zeros((R, 32), f)
            alpha = np.zeros(ld, f)
            for q in range(R):
                cols = lanes + 32 * q
                part = np.zeros((4, 32), f)
                for k0 in range(32 * q, 32 * R, 4):
                    if k0 < n:
                        v = np.zeros((32, 4), f)
                        v[cols < n] = wt[cols[cols < n], k0:k0 + 4]
                        part += (v * zs[k0:k0 + 4]).T
                        own[q, :, k0:k0 + 4] = v
                al[q] = (part[0] + part[1]) + (part[2] + part[3])
                alpha[cols[cols < n]] = al[q][cols < n]
                dr[m, cols[cols < n]] = (f(2) * f(gq[m]) * al[q])[cols < n]
            for a in range(n):
                part = np.zeros((R, 4, 32), f)
                for k1 in range(0, 32 * R, span):
                    if not (k1 + span - 1 >= a and k1 < n):
                        continue
                    for k0 in range(k1, k1 + span, 4):
                        v = _load4(wt, a, k0, k0 + 3 >= a and k0 < n)
                        for q in range(R):
                            if k0 >= 32 * q:
                                part[q] += v[:, None] * own[q, :, k0:k0 + 4].T
                for q in range(R):
                    cols = lanes + 32 * q
                    kinv = (part[q, 0] + part[q, 1]) + (part[q, 2] + part[q, 3])
                    row = f(gl[m]) * kinv - f(gq[m]) * (alpha[a] * al[q])
                    dkn[m, a, cols[cols < n]] = row[cols < n]
    return dkn, dr


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


def _factors(n):
    """L, z of the JAX forward on ``systems(n)`` (levels 0, 1, 2; the
    system failing every level left out) and gradients gq, gl."""
    kn, r = systems(n, seed=n)
    keep = np.arange(12) != FAILS
    _, _, L, z = (np.asarray(t) for t in jax_mll_fwd(jnp.asarray(kn), jnp.asarray(r),
                                                      interpret=True))
    rs = np.random.RandomState(100 + n)
    gq, gl = rs.randn(11).astype(np.float32), rs.randn(11).astype(np.float32)
    return L[keep], z[keep], gq, gl


@pytest.mark.parametrize("n", [9, 20, 32, 33, 48])
def test_bwd_warp_schedule_matches_pallas_kernel(n):
    """K3's schedule against the Pallas backward in interpret mode, on the
    JAX forward's L and z of systems at escalation levels 0, 1 and 2: dKn
    and dr within rtol 1e-4 per system, dKn exactly symmetric, and nothing
    read that the kernel leaves unwritten (all finite)."""
    L, z, gq, gl = _factors(n)
    dkn, dr = emulate_mll_bwd(L, z, gq, gl)
    assert np.all(np.isfinite(dkn)) and np.all(np.isfinite(dr))
    assert np.array_equal(dkn, dkn.transpose(0, 2, 1))
    want = jax_mll_bwd(jnp.asarray(L), jnp.asarray(z), jnp.asarray(gq[:, None]),
                       jnp.asarray(gl[:, None]), interpret=True)
    for got, ref in zip((dkn, dr), want):
        assert_close_per_system(got, np.asarray(ref), rtol=1e-4)


def test_bwd_warp_schedule_at_n64_matches_plain():
    """N=64, the wider instance's edge: K3's schedule on the plain forward's
    L and z against the port's plain backward, rtol 1e-4 per system."""
    kn, r = systems(64, seed=64)
    keep = np.arange(12) != FAILS
    _, _, L, z = mll_kernel.mll_fwd_ref(torch.from_numpy(kn[keep]), torch.from_numpy(r[keep]))
    rs = np.random.RandomState(164)
    gq, gl = rs.randn(11).astype(np.float32), rs.randn(11).astype(np.float32)
    dkn, dr = emulate_mll_bwd(L.numpy(), z.numpy(), gq, gl)
    assert np.array_equal(dkn, dkn.transpose(0, 2, 1))
    want = mll_kernel.mll_bwd_ref(L, z, torch.from_numpy(gq), torch.from_numpy(gl))
    for got, ref in zip((dkn, dr), want):
        assert_close_per_system(got, ref.numpy(), rtol=1e-4)
