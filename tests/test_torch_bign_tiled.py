"""The big-N kernels' tiled system algebra, emulated in float64 numpy, and their shared-memory plans.

B10 and B11 (csrc/fused_svgd_bign.cu, csrc/fused_vi_bign.cu) run each
system's GP algebra through csrc/bign_score.cuh on csrc/tiled_chol.cuh and
csrc/tiled_inverse.cuh: the bordered factor in 32-column panels (the border
row, the residual r, comes out as z = L^-1 r), W = L^-1 in place (every
diagonal tile inverted by one warp, then the panels from the last up: Y =
L21 W11 into a row buffer, W21 = -W22 Y in 4 x 4 micro-tiles), alpha = W^T
z, and K^-1 = W^T W in place (block rows of 32 from the top, each micro-tile
held until the block row's barrier). The kernels compile only on the card,
so here the same schedule runs in numpy: the same panel order, the same
reads of each phase and its in-place writes, the micro-tiles of an
unsynchronised phase applied as each is done, once in thread order and once
in reverse, and every entry above the diagonal (a packed row's padding)
NaN, so that a read-after-write fault or a missing mask shows. It is held
against ``np.linalg.cholesky`` / ``np.linalg.inv`` and, for the score
chain, against autograd of the kernels' plain MLL (``real_rows_mll``). The
blocked MLL backward (B4, csrc/blocked_mll.cu) runs the same inverse, alpha
and K^-1 on the forward's factor, then writes dKn whole: that composition is
held against its plain version ``blocked_mll_bwd_ref``.
"""

import numpy as np
import pytest
import torch

from meta_learning_pacoh_torch.ops.cuda.blocked_mll_kernel import blocked_mll_bwd_ref
from meta_learning_pacoh_torch.ops.cuda import fused_svgd_bign_kernel as sb
from meta_learning_pacoh_torch.ops.cuda import fused_vi_bign_kernel as vb
from meta_learning_pacoh_torch.ops.cuda.chol_kernel import SMEM_BYTES
from meta_learning_pacoh_torch.ops.cuda.fused_map_bign_kernel import real_rows_mll
from meta_learning_pacoh_torch.ops.cuda.fused_svgd_kernel import fused_prior

TILE = 32
JITTERS = (0.0, 1e-4, 1e-2)


def round4(x):
    return (x + 3) & ~3


class Packed:
    """The kernel's packed rows: row i holds columns 0..i and padding up to
    round4(i + 1), NaN until written; reads past the padding fail."""

    def __init__(self, n_rows, n):
        self.a = np.full((n_rows, round4(n_rows) + 4), np.nan)
        self.n = n

    def quad(self, i, c):  # row_quad: 16 bytes at column c <= i
        assert c % 4 == 0 and c <= i and c + 4 <= round4(i + 1), (i, c)
        return self.a[i, c:c + 4].copy()

    def store(self, i, c, v):  # row_quad_store
        assert c % 4 == 0 and c <= i and c + 4 <= round4(i + 1), (i, c)
        self.a[i, c:c + 4] = v

    def lower(self, rows):
        return np.tril(np.nan_to_num(self.a[:rows, :self.n], nan=0.0))


def factor(P, n_rows):
    """tiled_factor: panels of 32 columns; (a) the diagonal tile, (b) each row
    below solved against it (border row included), (c) the trailing lower
    triangle updated by micro-tiles. Returns whether every pivot was
    positive."""
    n = P.n
    for j0 in range(0, n, TILE):
        jb = min(TILE, n - j0)
        j_end = j0 + jb
        a = np.array([[P.a[j0 + r, j0 + c] if c <= r else 0.0 for c in range(jb)]
                      for r in range(jb)])
        L = np.zeros_like(a)
        for j in range(jb):  # the warp's column chain
            p = a[j, j] - L[j, :j] @ L[j, :j]
            if not (p > 0 and np.isfinite(p)):
                return False
            L[j, j] = np.sqrt(p)
            for r in range(j + 1, jb):
                L[r, j] = (a[r, j] - L[r, :j] @ L[j, :j]) / L[j, j]
        for r in range(jb):
            P.a[j0 + r, j0:j0 + r + 1] = L[r, :r + 1]
        panel = np.zeros((n_rows - j_end, TILE))
        for i in range(j_end, n_rows):  # a thread a row
            x = np.linalg.solve(L, P.a[i, j0:j_end])  # x L^T = a
            P.a[i, j0:j_end] = x
            panel[i - j_end, :jb] = x
        for r in range(j_end, n_rows):  # micro-tiles write only their own entries
            cols = np.arange(j_end, min(r + 1, n))
            P.a[r, cols] -= panel[cols - j_end] @ panel[r - j_end]
    return True


def tile_invert(P, j0, jb):
    """One warp: row r of W11 = L11^-1 built lane by lane; returns sum log L_cc."""
    a = np.eye(TILE)
    for r in range(jb):
        row = np.concatenate([P.quad(j0 + r, j0 + 4 * q) for q in range(r // 4 + 1)])
        a[r, :r + 1] = row[:r + 1]
    lg = sum(np.log(a[r, r]) for r in range(jb))
    x = np.eye(TILE)
    for k in range(TILE):
        x[k, :k + 1] /= a[k, k]
        for r in range(k + 1, TILE):
            x[r, :k + 1] -= a[r, k] * x[k, :k + 1]
    for r in range(jb):
        for q in range(r // 4 + 1):
            P.store(j0 + r, j0 + 4 * q, x[r, 4 * q:4 * q + 4])
    return lg


def invert(P, order):
    """tiled_invert: the diagonal tiles, then the panels from the last up."""
    n = P.n
    nt = -(-n // TILE)
    logs = [tile_invert(P, TILE * t, min(TILE, n - TILE * t)) for t in range(nt)]
    for p in range(nt - 2, -1, -1):
        j0 = TILE * p
        j_end = j0 + TILE
        w11 = np.zeros((TILE, TILE))
        for m in range(TILE):
            quads = np.concatenate([P.quad(j0 + m, j0 + 4 * q) for q in range(m // 4 + 1)])
            w11[m, :m + 1] = quads[:m + 1]
        ybuf = np.full((n - j_end + 4, TILE), np.nan)
        for i in range(j_end, n):  # a row a thread, into the buffer only
            x = np.concatenate([P.quad(i, j0 + 4 * q) for q in range(TILE // 4)])
            ybuf[i - j_end] = x @ w11
        tiles = [(j_end + 4 * (t // 8), 4 * (t % 8)) for t in range(-(-(n - j_end) // 4) * 8)]
        for i0, c0 in tiles[::order]:  # written as each is done
            acc = np.zeros((4, 4))
            for k in range(j_end, i0 + 1, 4):
                w = np.array([P.quad(i0 + u, k) if i0 + u < n else np.zeros(4) for u in range(4)])
                if k == i0:
                    w = np.where(np.arange(4)[None, :] > np.arange(4)[:, None], 0.0, w)
                y = np.array([ybuf[k + u - j_end, c0:c0 + 4] if k + u < n else np.zeros(4)
                              for u in range(4)])
                acc += w @ y
            for u in range(4):
                if i0 + u < n:
                    P.store(i0 + u, j0 + c0, -acc[u])
    return logs


def wt_times(P, z):
    n = P.n
    return np.array([sum(P.a[k, a] * z[k] for k in range(a, n)) for a in range(n)])


def lauum_tiles(n, r0, rh):
    """The micro-tiles of tiled_lauum's block row at r0 of rh rows."""
    tr = -(-min(rh, n - r0) // 4)
    return tr * (r0 // 4) + tr * (tr + 1) // 2


def lauum_height(n, threads):
    """tiled_lauum's block rows: 32, halved while one has more micro-tiles
    than the block's threads (down to 4)."""
    rh = TILE
    while rh > 4 and any(lauum_tiles(n, r0, rh) > threads for r0 in range(0, n, rh)):
        rh //= 2
    return rh


def group_lanes(items, reach, threads):
    """csrc/lane_sums.cuh's group_lanes at a block of ``threads``."""
    g = 1
    while g < 32 and items * 2 * g <= threads and 4 * g <= reach:
        g *= 2
    return g


def rows_covered(n, threads):
    """Whether the phases of a system that give each item one group of lanes
    with no stride cover their items at a block of ``threads``:
    tiled_wt_times (a row of alpha a group) and tiled_lauum (a micro-tile a
    group). Every other phase of bign_score.cuh, tiled_chol.cuh,
    tiled_inverse.cuh and fused_update.cuh strides over blockDim.x (or
    warps, or runs rounds of the block), and K <= 32 rows of the kernel
    matrix take a thread each."""
    if n * group_lanes(n, n, threads) > threads:
        return False
    rh = lauum_height(n, threads)
    for r0 in range(0, n, rh):
        tiles = lauum_tiles(n, r0, rh)
        if tiles * group_lanes(tiles, n - r0, threads) > threads:
            return False
    return True


def lauum(P, order, threads=512):
    """tiled_lauum: block rows of 32 from the top (halved while one has more
    micro-tiles than the block's threads), each micro-tile held until the
    block row's barrier."""
    n = P.n
    rh = lauum_height(n, threads)
    for r0 in range(0, n, rh):
        tr = -(-min(rh, n - r0) // 4)
        tiles = [(r0 + 4 * R, 4 * C) for R in range(tr) for C in range(r0 // 4 + R + 1)]
        held = []
        for i0, c0 in tiles[::order]:
            acc = np.zeros((4, 4))
            for k in range(i0, n):
                a, b = P.quad(k, i0), P.quad(k, c0)
                a = np.where(i0 + np.arange(4) <= k, a, 0.0)
                b = np.where(c0 + np.arange(4) <= k, b, 0.0)
                acc += np.outer(a, b)
            held.append((i0, c0, acc))
        for i0, c0, acc in held:
            for u in range(4):
                if i0 + u < n:
                    P.store(i0 + u, c0, acc[u])


def backward_schedule(L, z, gq, gl, order, threads=512):
    """The B4 backward's algebra (csrc/blocked_mll.cu): L's lower triangle
    packed, W = L^-1, alpha = W^T z and K^-1 = W^T W in place, then dKn_ab =
    gl K^-1 - gq alpha_a alpha_b from the lower triangle (row a for b <= a,
    row b above) and dr = 2 gq alpha."""
    n = len(z)
    P = Packed(n, n)
    for i in range(n):
        P.a[i, :i + 1] = L[i, :i + 1]
    invert(P, order)
    alpha = wt_times(P, z)
    lauum(P, order, threads)
    C = P.lower(n)
    kinv = np.where(np.arange(n)[None, :] <= np.arange(n)[:, None], C, C.T)
    return gl * kinv - gq * (alpha[:, None] * alpha[None, :]), 2.0 * gq * alpha


def system(n, seed, ragged, diag_add=None):
    """A kernel system as bign_task_grad builds it: features z (with two
    duplicated inputs when diag_add is negative, so that level 0 fails), mask,
    residual r; returns (ph, msk, r, diag_add)."""
    rs = np.random.RandomState(seed)
    ph = rs.uniform(-2.0, 2.0, n)
    msk = np.ones(n)
    if ragged:
        msk[n - 3:] = 0.0
        ph[n - 3:] = 0.0
    if diag_add is None:
        diag_add = 0.05 + 0.01 * rs.rand()
    else:
        ph[1] = ph[0]
    r = rs.randn(n) * msk
    return ph, msk, r, diag_add


def bordered(ph, msk, r, diag_add, jit):
    n = len(ph)
    kn = np.exp(-0.5 * (ph[:, None] - ph[None, :]) ** 2) * msk[:, None] * msk[None, :]
    kn += np.diag(np.where(msk > 0, diag_add + jit, 1.0))
    return kn


def run_schedule(ph, msk, r, diag_add, order):
    """bign_task_grad's algebra: (level, z, W, K^-1 lower, alpha, quad + logdet)."""
    n = len(ph)
    for level, jit in enumerate(JITTERS):
        P = Packed(n + 1, n)
        kn = bordered(ph, msk, r, diag_add, jit)
        for i in range(n):
            P.a[i, :i + 1] = kn[i, :i + 1]
        P.a[n, :n] = r
        if factor(P, n + 1):
            break
    else:
        raise AssertionError("no level factors")
    L = P.lower(n)
    z = P.a[n, :n].copy()
    logs = invert(P, order)
    W = P.lower(n)
    alpha = wt_times(P, z)
    lauum(P, order)
    return level, L, z, W, P.lower(n), alpha, z @ z + 2.0 * sum(logs)


CASES = [(n, ragged) for n in (9, 31, 32, 33, 64, 200, 256) for ragged in (False, True)]


@pytest.mark.parametrize("n,ragged", CASES)
def test_tiled_schedule_matches_numpy(n, ragged):
    """Factor, border row, inverse, alpha and K^-1 of the tiled schedule
    against numpy in float64, in both orders of each phase's micro-tiles."""
    ph, msk, r, diag_add = system(n, 1000 + n, ragged)
    kn = bordered(ph, msk, r, diag_add, 0.0)
    L_ref = np.linalg.cholesky(kn)
    kinv = np.linalg.inv(kn)
    tol = 1e-9 * np.abs(kinv).max()
    for order in (1, -1):
        level, L, z, W, C, alpha, ql = run_schedule(ph, msk, r, diag_add, order)
        assert level == 0
        np.testing.assert_allclose(L, L_ref, atol=1e-12)
        np.testing.assert_allclose(z, np.linalg.solve(L_ref, r), atol=1e-9)
        np.testing.assert_allclose(W, np.linalg.inv(L_ref), atol=tol)
        np.testing.assert_allclose(C, np.tril(kinv), atol=tol)
        np.testing.assert_allclose(alpha, kinv @ r, atol=tol * np.abs(r).sum())
        ref = r @ kinv @ r + np.linalg.slogdet(kn)[1]
        np.testing.assert_allclose(ql, ref, rtol=1e-10)


@pytest.mark.parametrize("n", (33, 200))
def test_tiled_schedule_escalates_to_level_1(n):
    """Two duplicated inputs and a diagonal 5e-5 short of the Gram matrix's
    null direction: level 0 meets a negative pivot, level 1 (1e-4 on the real
    rows) factors, and the algebra is that of the level-1 system."""
    ph, msk, r, diag_add = system(n, 7 + n, True, diag_add=-5e-5)
    level, L, z, W, C, alpha, ql = run_schedule(ph, msk, r, diag_add, 1)
    assert level == 1
    kn = bordered(ph, msk, r, diag_add, 1e-4)
    kinv = np.linalg.inv(kn)
    np.testing.assert_allclose(L, np.linalg.cholesky(kn), atol=1e-9)
    np.testing.assert_allclose(C, np.tril(kinv), rtol=1e-6, atol=1e-6 * np.abs(kinv).max())
    np.testing.assert_allclose(ql, r @ kinv @ r + np.linalg.slogdet(kn)[1], rtol=1e-7)


@pytest.mark.parametrize("n,ragged", [(33, True), (64, False)])
def test_score_chain_on_the_schedule_matches_autograd(n, ragged):
    """The score loop of bign_task_grad on the schedule's K^-1 (each entry
    read once from the lower triangle) against autograd of the plain MLL
    ``real_rows_mll`` in float64: d(w ll)/d(mean) = w alpha m and
    d(w ll)/d(feature)."""
    ph, msk, r, diag_add = system(n, 50 + n, ragged)
    rs = np.random.RandomState(n)
    mu = rs.randn(n) * msk
    y = r + mu
    sp_ls, w = 0.7, 0.3
    z_ = ph / sp_ls
    _, _, _, _, C, alpha, _ = run_schedule(z_, msk, r, diag_add, 1)
    d_mean = w * alpha * msk
    d_feat = np.zeros(n)
    for a in range(n):
        dz = 0.0
        for b in range(n):
            s = 0.5 * w * (alpha[a] * alpha[b] - (C[a, b] if b <= a else C[b, a]))
            diff = z_[a] - z_[b]
            dd2 = -0.5 * s * msk[a] * msk[b] * np.exp(-0.5 * diff * diff) if diff * diff > 0 else 0.0
            dz += 4.0 * dd2 * diff
        d_feat[a] = dz / sp_ls

    mean = torch.tensor(mu, requires_grad=True)
    feat = torch.tensor(ph, requires_grad=True)
    zt = feat / sp_ls
    K = torch.exp(-0.5 * (zt[:, None] - zt[None, :]) ** 2)
    m = torch.tensor(msk)
    ll = real_rows_mll(mean, K, torch.tensor(y), torch.tensor(diag_add - 1e-6, dtype=torch.float64), m)
    (w * ll * m.sum()).backward()
    np.testing.assert_allclose(d_mean, mean.grad.numpy(), atol=1e-10)
    np.testing.assert_allclose(d_feat, feat.grad.numpy(), atol=1e-9)


@pytest.mark.parametrize("n,threads", [(49, 512), (97, 512), (97, 64), (200, 512)])
def test_blocked_backward_composition_matches_plain(n, threads):
    """The B4 backward's composition on the tiled schedule (invert, alpha,
    lauum, the symmetric dKn and dr) against ``blocked_mll_bwd_ref`` in
    float64, in both orders of each phase's micro-tiles; dKn comes out
    exactly symmetric. At 64 emulated threads K^-1's block rows halve, as
    they do past N = 280 at the kernel's 512."""
    rs = np.random.RandomState(n + threads)
    g = rs.randn(n, n + 3)
    L = np.linalg.cholesky(g @ g.T / n + 0.5 * np.eye(n))
    z, gq, gl = rs.randn(n), rs.randn(), rs.randn()
    dkn_ref, dr_ref = (a[0].numpy() for a in blocked_mll_bwd_ref(
        torch.from_numpy(L)[None], torch.from_numpy(z)[None],
        torch.tensor([gq], dtype=torch.float64), torch.tensor([gl], dtype=torch.float64)))
    for order in (1, -1):
        dkn, dr = backward_schedule(L, z, gq, gl, order, threads)
        assert np.array_equal(dkn, dkn.T)
        np.testing.assert_allclose(dkn, dkn_ref, atol=1e-10 * np.abs(dkn_ref).max())
        np.testing.assert_allclose(dr, dr_ref, atol=1e-10 * np.abs(dr_ref).max())


def grid():
    for n in (9, 20, 31, 32, 33, 64, 100, 128, 129, 200, 207, 208, 225, 240, 255, 256):
        for k in (1, 2, 10, 32):
            for h in (8, 16, 32, 64):
                yield n, k, h


def test_plans_cover_the_window():
    """Every shape of a grid over the window (N 9-256, K or S 1-32, widths
    8-64, two layers, D 1-2, T 1-100) gets a plan from both wrappers within
    one Hopper block's shared memory, at the most that fits there (2 the
    matrix and the activations, 1 the matrix, 0 neither); every plan is
    resident (blocks <= 132 s and s blocks' shared memory within an SM's,
    s = 512 / its width), each block walks at least one system, and every
    phase covers its rows at the plan's width; at svgd_t5_n200 and
    vi_t5_n200 both the packed triangle and the activations are in shared
    memory, one 512-thread block a system."""
    for n, k, h in grid():
        hidden = (h, h)
        for d in (1, 2):
            p = fused_prior(d, hidden, 1.0, 1.0).dim
            for t in (1, 5, 100):
                sp = sb.svgd_bign_plan(k, t, n, d, hidden)
                vp = vb.vi_bign_plan(k, t, n, d, hidden)
                assert sp is not None and vp is not None, (n, k, h, d, t)
                svgd = [sb.smem_bytes(k, n, d, p, s, hidden) <= SMEM_BYTES for s in (0, 1, 2)]
                vi = [vb.smem_bytes(n, d, p, s, hidden) <= SMEM_BYTES for s in (0, 1, 2)]
                assert svgd[sp[2]] and not any(svgd[sp[2] + 1:]), (n, k, h, d, t, sp)
                assert vi[vp[2]] and not any(vi[vp[2] + 1:]), (n, k, h, d, t, vp)
                for plan, smem, threads in (
                        (sp, sb.smem_bytes(k, n, d, p, sp[2], hidden), sp[3]),
                        (vp, vb.smem_bytes(n, d, p, vp[2], hidden), sb.THREADS)):
                    per_sm = sb.THREADS // threads
                    blocks, spb = plan[:2]
                    assert blocks <= sb.N_SM * per_sm and (blocks - 1) * spb < k * t <= blocks * spb
                    assert per_sm * (smem + sb.BLOCK_RESERVED_SMEM) <= sb.SM_SMEM_BYTES
                    assert rows_covered(n, threads), (n, k, h, d, t, plan)
    assert sb.svgd_bign_plan(10, 5, 200, 1, (32, 32)) == (50, 1, 2, 512)
    assert vb.vi_bign_plan(10, 5, 200, 1, (32, 32)) == (50, 1, 2)
    # wide nets push the triangle to device memory
    assert sb.svgd_bign_plan(4, 2, 240, 1, (128, 128))[2] == 0
    assert vb.vi_bign_plan(4, 2, 240, 1, (128, 128))[2] == 0


def test_n_wide_is_the_last_n_every_phase_covers():
    """N_WIDE, the largest N of a two-blocks-an-SM plan, is the largest N
    whose every phase covers its rows at 256 threads (tiled_wt_times' one
    row a group binds); at 512 every N of the window is covered."""
    half = sb.THREADS // 2
    assert all(rows_covered(n, half) for n in range(sb.MIN_N, sb.N_WIDE + 1))
    assert not rows_covered(sb.N_WIDE + 1, half)
    assert all(rows_covered(n, sb.THREADS) for n in range(sb.MIN_N, sb.MAX_N + 1))


def test_smem_mirror_counts_the_layout():
    """The wrappers' byte counts are the sources' smem_floats: the tiled
    matrix's area (scratch, and the packed rows of N + 1 rows when shared),
    the parameters, N (D + 10) + 16 floats of vectors, the kernel's own and,
    at placement 2, both nets' activations [2][L][H][N | 1]."""
    n, d, p, k, hidden = 200, 1, 2308, 10, (32, 32)
    ldp = round4(n + 1 - TILE)
    scratch = TILE * TILE + 4 + TILE * ldp
    packed = sum(round4(i + 1) for i in range(n + 1))
    vec = n * (d + 10) + 16
    acts = 2 * (n | 1) * sum(hidden)
    own = 2 * k * k + k + 1
    assert sb.smem_bytes(k, n, d, p, 2, hidden) == 4 * (scratch + packed + p + vec + own + acts)
    assert sb.smem_bytes(k, n, d, p, 1, hidden) == 4 * (scratch + packed + p + vec + own)
    assert sb.smem_bytes(k, n, d, p, 0, hidden) == 4 * (scratch + p + vec + own)
    assert vb.smem_bytes(n, d, p, 2, hidden) == 4 * (scratch + packed + p + vec + 32 + acts)
