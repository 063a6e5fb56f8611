"""The port's blocked MLL core (B4) against the JAX package's.

On the CPU ``blocked_mll_quad_logdet`` takes its plain version (a factor at
the escalated jitter, triangular solves, the closed-form backward); the JAX
side runs the Pallas kernel ``blocked_mll_quad_logdet`` in interpret mode,
as tests/test_blocked_mll.py runs it. Inputs come from numpy seeds.

Tolerances: quad and logdet rtol 2e-5 (float32 factorizations in another
order; the TPU kernel takes logdet from the diagonal blocks' inverses, the
port from L's diagonal, which differ in the last ulp), gradients rtol 1e-4
at N=72 and 2e-4 at N=200 with atol a tenth of that, as the JAX package's
own tests hold its kernel against XLA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_learning_pacoh_tpu.ops.pallas.blocked_mll_kernel import (
    blocked_mll_quad_logdet as jax_blocked,
)
from meta_learning_pacoh_torch.ops import gp as gp_ops
from meta_learning_pacoh_torch.ops.cuda import blocked_mll_kernel as bk
from meta_learning_pacoh_torch.ops.cuda import chol_kernel


def _psd(b, n, seed, scale=0.5):
    rs = np.random.RandomState(seed)
    a = rs.randn(b, n + 3, n).astype(np.float32)
    return (np.einsum("bin,bim->bnm", a, a) / n + scale * np.eye(n, dtype=np.float32)).astype(
        np.float32)


def _escalating(n, lam_min, rs):
    """Symmetric, eigenvalues in [1e-4, 1e-3] but one lam_min < 0: its
    factorization fails at jitter 0 and succeeds once jitter > -lam_min."""
    q, _ = np.linalg.qr(rs.randn(n, n))
    lam = rs.uniform(1e-4, 1e-3, n)
    lam[0] = lam_min
    return ((q * lam) @ q.T).astype(np.float32)


def _port(kn, r):
    kn_t = torch.from_numpy(kn).requires_grad_(True)
    r_t = torch.from_numpy(r).requires_grad_(True)
    quad, logdet = bk.blocked_mll_quad_logdet(kn_t, r_t)
    torch.sum(0.7 * quad + 0.3 * logdet).backward()
    return quad.detach().numpy(), logdet.detach().numpy(), kn_t.grad.numpy(), r_t.grad.numpy()


def _jax(kn, r):
    def loss(k, rr):
        q, ld = jax_blocked(k, rr)
        return jnp.sum(0.7 * q + 0.3 * ld)

    quad, logdet = jax_blocked(jnp.asarray(kn), jnp.asarray(r))
    gk, gr = jax.grad(loss, argnums=(0, 1))(jnp.asarray(kn), jnp.asarray(r))
    return np.asarray(quad), np.asarray(logdet), np.asarray(gk), np.asarray(gr)


def _sym(m):
    return 0.5 * (m + np.swapaxes(m, -1, -2))


@pytest.mark.parametrize("n,rtol", [(72, 1e-4), (200, 2e-4)])
def test_values_and_gradients_match_jax(n, rtol):
    """B=2 systems: quad, logdet rtol 2e-5; dKn (symmetrised: the JAX VJP
    and the port's need not split an off-diagonal pair alike) and dr at
    ``rtol`` with atol rtol / 10."""
    kn = _psd(2, n, seed=n)
    r = np.random.RandomState(n + 1).randn(2, n).astype(np.float32)
    got, want = _port(kn, r), _jax(kn, r)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(_sym(got[2]), _sym(want[2]), rtol=rtol, atol=rtol / 10)
    np.testing.assert_allclose(got[3], want[3], rtol=rtol, atol=rtol / 10)


def test_jitter_escalates_per_system():
    """One batch, N=60: system 0 factors at jitter 0, system 1 needs 1e-4
    (an eigenvalue at -5e-5), system 2 needs 1e-2 (one at -5e-3). Each
    system's quad and logdet equal float64's at its own level (rtol 1e-4 of
    conditioning up to 1e3), and the JAX kernel's (rtol 1e-4); the
    gradients agree with the JAX kernel's at rtol 1e-3, atol 1e-3 of their
    scale (the 1e-4-level system has a condition number near 1e4)."""
    n = 60
    rs = np.random.RandomState(3)
    kn = _psd(3, n, seed=4)
    kn[1] = _escalating(n, -5e-5, rs)
    kn[2] = _escalating(n, -5e-3, rs)
    r = rs.randn(3, n).astype(np.float32)
    lam_min = [float(np.linalg.eigvalsh(kn[s].astype(np.float64))[0]) for s in range(3)]
    assert lam_min[0] > 0 and -1e-4 < lam_min[1] < 0 and -1e-2 < lam_min[2] < -1e-4
    got, want = _port(kn, r), _jax(kn, r)
    for s, jit in enumerate((0.0, 1e-4, 1e-2)):  # each at its own level, no other
        a = kn[s].astype(np.float64) + jit * np.eye(n)
        quad = r[s] @ np.linalg.solve(a, r[s].astype(np.float64))
        logdet = np.linalg.slogdet(a)[1]
        np.testing.assert_allclose(got[0][s], quad, rtol=1e-4, err_msg=f"system {s}")
        np.testing.assert_allclose(got[1][s], logdet, rtol=1e-4, err_msg=f"system {s}")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
    for g, w in ((_sym(got[2]), _sym(want[2])), (got[3], want[3])):
        scale = np.abs(w).reshape(3, -1).max(axis=1)
        err = np.abs(g - w).reshape(3, -1).max(axis=1)
        assert np.all(err <= 1e-3 * scale), err / scale


def _routes(monkeypatch):
    """Count the calls gp_mll_batch makes to each core."""
    calls = {"mll": 0, "blocked": 0}

    def counted(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(gp_ops, "mll_quad_logdet", counted("mll", gp_ops.mll_quad_logdet))
    monkeypatch.setattr(gp_ops, "blocked_mll_quad_logdet",
                        counted("blocked", gp_ops.blocked_mll_quad_logdet))
    return calls


@pytest.mark.parametrize("n,route", [(9, "mll"), (48, "mll"), (49, "blocked"),
                                     (200, "blocked"), (512, "blocked"), (513, None)])
def test_gp_mll_batch_routes_by_n(monkeypatch, n, route):
    """N <= 48 stays on K2/K3, 49 <= N <= 512 goes to B4, N = 513 to the
    plain ``gp_mll``; with the kernels off every N takes ``gp_mll``."""
    monkeypatch.delenv("PACOH_TORCH_DISABLE_KERNELS", raising=False)
    calls = _routes(monkeypatch)
    rs = np.random.RandomState(n)
    K = torch.from_numpy(_psd(2, n, seed=n, scale=0.1))
    mean, y = (torch.from_numpy(rs.randn(2, n).astype(np.float32)) for _ in range(2))
    ll = gp_ops.gp_mll_batch(mean, K, y, 0.3)
    assert calls == {"mll": int(route == "mll"), "blocked": int(route == "blocked")}
    monkeypatch.setenv("PACOH_TORCH_DISABLE_KERNELS", "1")
    ll_plain = gp_ops.gp_mll_batch(mean, K, y, 0.3)
    assert calls == {"mll": int(route == "mll"), "blocked": int(route == "blocked")}
    np.testing.assert_allclose(ll.numpy(), ll_plain.numpy(), rtol=2e-5)


def test_gp_mll_batch_blocked_matches_jax_with_ragged_masks(monkeypatch):
    """gp_mll_batch at N=56 with a ragged mask, through B4, against the JAX
    gp_mll_batch through its blocked kernel (interpret mode): rtol 5e-5, the
    tolerance of tests/test_blocked_mll.py's dispatch test; and the
    gradient in K and the mean at rtol 1e-4."""
    from meta_learning_pacoh_tpu.ops.gp import gp_mll_batch as jax_gp_mll_batch

    monkeypatch.setenv("PACOH_TPU_FORCE_PALLAS", "1")
    calls = _routes(monkeypatch)
    b, n = 3, 56
    rs = np.random.RandomState(6)
    mean, y = rs.randn(b, n).astype(np.float32), rs.randn(b, n).astype(np.float32)
    K = _psd(b, n, seed=7, scale=0.1)
    mask = np.ones((b, n), np.float32)
    mask[1, -9:] = 0.0
    K_t, mean_t = torch.from_numpy(K).requires_grad_(True), torch.from_numpy(mean).requires_grad_(
        True)
    ll = gp_ops.gp_mll_batch(mean_t, K_t, torch.from_numpy(y), 0.3, torch.from_numpy(mask))
    torch.sum(ll).backward()
    assert calls["blocked"] == 1

    def jax_loss(k, m):
        return jnp.sum(jax_gp_mll_batch(m, k, jnp.asarray(y), 0.3, jnp.asarray(mask)))

    want = jax_gp_mll_batch(jnp.asarray(mean), jnp.asarray(K), jnp.asarray(y), 0.3,
                            jnp.asarray(mask))
    gk, gm = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(K), jnp.asarray(mean))
    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(want), rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(_sym(K_t.grad.numpy()), _sym(np.asarray(gk)), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mean_t.grad.numpy(), np.asarray(gm), rtol=1e-4, atol=1e-5)


def test_shared_memory_edge_and_wrapper_checks():
    """The forward holds its packed system in shared memory up to N=307 and
    the backward its packed triangle up to N=306 (the edges the card tests
    cross); the CPU wrapper is the plain version; shapes out of the window are
    refused on the card's path before any launch."""
    assert bk.SHARED_MAX_N == 307
    assert bk.blocked_in_shared(307) and not bk.blocked_in_shared(308)
    assert bk.BWD_SHARED_MAX_N == 306
    assert bk.blocked_bwd_in_shared(306) and not bk.blocked_bwd_in_shared(307)
    kn = torch.from_numpy(_psd(2, 50, seed=1))
    r = torch.ones(2, 50)
    for got, want in zip(bk.blocked_mll_fwd(kn, r), bk.blocked_mll_fwd_ref(kn, r)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        bk._check("blocked_mll", 2, 513, ())


# a block's opt-in limit, and an SM's shared memory less 1 KB a resident block
OPTIN_BYTES, SM_BYTES, BLOCK_RESERVED = 232448, 233472, 1024


@pytest.mark.parametrize("name,rows_of,max_n,two_up_to", [
    ("chol", lambda n: n, 308, 208),
    ("blocked_fwd", lambda n: n + 1, 307, 207),
    ("blocked_bwd", lambda n: n, 306, 206),
])
def test_tiled_footprint_fits_where_claimed(name, rows_of, max_n, two_up_to):
    """The tiled kernels' shared-memory budget (csrc/tiled_chol.cuh, mirrored
    by ``chol_kernel.tiled_shared_bytes``; the B4 backward adds z, alpha and
    the tiles' log sums, ``bwd_shared_bytes``) fits a block's opt-in limit at
    every N the wrappers hold in shared memory, and two blocks an SM up to
    N=208 (K4) / 207 (the B4 forward) / 206 (the B4 backward), bench.py's
    N=200 among them."""
    in_shared = {"chol": chol_kernel.chol_in_shared, "blocked_fwd": bk.blocked_in_shared,
                 "blocked_bwd": bk.blocked_bwd_in_shared}[name]
    def footprint(n):
        if name == "blocked_bwd":
            return bk.bwd_shared_bytes(n)
        return chol_kernel.tiled_shared_bytes(n, rows_of(n))
    claimed = [n for n in range(1, 513) if in_shared(n)]
    assert claimed == list(range(1, max_n + 1))
    for n in claimed:
        assert footprint(n) <= OPTIN_BYTES
    two = [n for n in range(1, 513) if 2 * (footprint(n) + BLOCK_RESERVED) <= SM_BYTES]
    assert two == list(range(1, two_up_to + 1))


def test_tiled_packed_rows_are_aligned_and_dense():
    """Row i of the packed triangle starts at the closed form of
    csrc/tiled_chol.cuh's packed_off, on a 16-byte boundary, right after row
    i - 1's round4(i) floats, and the trailing update's tiles (numbered row
    by row, the border's last tile row beyond the last column tile skipped)
    cover the trailing lower triangle once."""
    def packed_off(i):
        q, rem = i >> 2, i & 3
        return 8 * q * (q + 1) + 4 * rem * (q + 1)

    off = 0
    for i in range(514):
        assert packed_off(i) == off and off % 4 == 0
        off += (i + 4) & ~3
    assert chol_kernel.tiled_shared_bytes(200, 200) == 4 * (32 * 32 + 4 + 32 * 168 + packed_off(200))
    for m_rows, m_cols in ((168, 168), (169, 168), (170, 169), (9, 8), (5, 4)):
        tr, tc = (m_rows + 3) // 4, (m_cols + 3) // 4
        seen = set()
        for t in range(tr * (tr + 1) // 2):
            row = int((np.sqrt(np.float32(8 * t + 1)) - 1) * 0.5)
            while row * (row + 1) // 2 > t:
                row -= 1
            while (row + 1) * (row + 2) // 2 <= t:
                row += 1
            col = t - row * (row + 1) // 2
            if col >= tc:
                continue
            seen |= {(4 * row + u, 4 * col + v) for u in range(4) for v in range(4)
                     if 4 * row + u < m_rows and 4 * col + v < m_cols
                     and 4 * col + v <= 4 * row + u}
        assert seen == {(r, c) for r in range(m_rows) for c in range(min(r + 1, m_cols))}
