"""The PACOH-MAP kernels' designs on the CPU: B9's tiled system algebra emulated in float64 numpy, and the plans of B9 and B6.

B9 (csrc/fused_map_bign.cu) runs each task's GP system through the 32-column
panels of csrc/tiled_chol.cuh (the residual as the border row, so z = L^-1 r
comes out of the factor) and csrc/tiled_inverse.cuh (W = L^-1, then K^-1 =
W^T W in place: block rows of 32, or of 16 where a block row of 32 has more
micro-tiles than the block's 512 threads), with F features, the outputscale
and N up to 512. The kernels compile only on the card, so here the same
schedule runs in numpy: the same panel order, the same reads of each phase
and its in-place writes, the micro-tiles of an unsynchronised phase applied
as each is done, once in thread order and once in reverse, and every entry
above the diagonal (a packed row's padding) NaN, so that a read-after-write
fault or a missing mask shows. It is held against ``np.linalg`` and, for the
score chain (d(mean), d(feature) [N][F], d(lengthscale), d(outputscale),
d(noise)), against autograd of the kernel's plain MLL (``real_rows_mll``).

The plans: B9's placements and the shared-memory count of its source,
mirrored; its window, the first design's, unchanged; B6's cluster plan
over a grid of T, N, F and widths (task split, slices, bytes per CTA).
"""

import numpy as np
import pytest
import torch

from meta_learning_pacoh_torch.models.random_gp import layout_dim
from meta_learning_pacoh_torch.ops.cuda import fused_map_bign_kernel as bg
from meta_learning_pacoh_torch.ops.cuda import fused_map_kernel as mk
from meta_learning_pacoh_torch.ops.cuda.chol_kernel import SMEM_BYTES

TILE = 32
THREADS = 512  # csrc/fused_map_bign.cu kThreads
JITTERS = (0.0, 1e-4, 1e-2)


def round4(x):
    return (x + 3) & ~3


def padded(n_rows, n):
    """The kernel's rows: row i holds columns 0..i, NaN above (a packed row's
    padding, or the square's upper triangle)."""
    return np.full((n_rows, round4(n_rows) + 4), np.nan)


def lower0(a, i0, i1, c0, c1):
    """Block [i0:i1, c0:c1] of the rows with the entries above the diagonal
    read as 0 (the kernels' masks)."""
    blk = a[i0:i1, c0:c1]
    rows = np.arange(i0, i1)[:, None]
    cols = np.arange(c0, c1)[None, :]
    return np.where(cols <= rows, blk, 0.0)


def factor(a, n, n_rows):
    """tiled_factor: panels of 32 columns; (a) the diagonal tile, (b) each row
    below solved against it (the border row included), (c) the trailing
    lower triangle. Returns whether every pivot was positive."""
    for j0 in range(0, n, TILE):
        jb = min(TILE, n - j0)
        j_end = j0 + jb
        t = lower0(a, j0, j_end, j0, j_end)
        L = np.zeros_like(t)
        for j in range(jb):  # the warp's column chain
            p = t[j, j] - L[j, :j] @ L[j, :j]
            if not (p > 0 and np.isfinite(p)):
                return False
            L[j, j] = np.sqrt(p)
            L[j + 1:, j] = (t[j + 1:, j] - L[j + 1:, :j] @ L[j, :j]) / L[j, j]
        for r in range(jb):
            a[j0 + r, j0:j0 + r + 1] = L[r, :r + 1]
        if j_end >= n_rows:
            continue
        x = np.linalg.solve(L, a[j_end:n_rows, j0:j_end].T).T  # a thread a row: x L^T = a
        a[j_end:n_rows, j0:j_end] = x
        for r in range(j_end, n_rows):  # micro-tiles write only their own entries
            cols = np.arange(j_end, min(r + 1, n))
            a[r, cols] -= x[cols - j_end] @ x[r - j_end]
    return True


def invert(a, n, order):
    """tiled_invert: every diagonal tile (a warp each), then the panels from the
    last up: Y = L21 W11 into a buffer, W21 = -W22 Y by micro-tiles written as
    each is done (a second round where there are more than 512)."""
    nt = -(-n // TILE)
    logs = []
    for t in range(nt):
        j0, jb = TILE * t, min(TILE, n - TILE * t)
        L = lower0(a, j0, j0 + jb, j0, j0 + jb)
        logs.append(np.log(np.diag(L)).sum())
        W = np.linalg.inv(L)
        for r in range(jb):
            a[j0 + r, j0:j0 + r + 1] = W[r, :r + 1]
    for p in range(nt - 2, -1, -1):
        j0, j_end = TILE * p, TILE * p + TILE
        w11 = lower0(a, j0, j_end, j0, j_end)
        ybuf = a[j_end:n, j0:j_end] @ w11  # a row a thread, into the buffer only
        tiles = [(j_end + 4 * (t // 8), 4 * (t % 8)) for t in range(-(-(n - j_end) // 4) * 8)]
        for i0, c0 in tiles[::order]:
            i1 = min(i0 + 4, n)
            w = lower0(a, i0, i1, j_end, i1)  # W22's rows i0.., columns j_end..i0+3
            a[i0:i1, j0 + c0:j0 + c0 + 4] = -(w @ ybuf[:i1 - j_end, c0:c0 + 4])
    return logs


def lauum_rows(n, threads=THREADS):
    """tiled_lauum's block-row height: 32, halved while a block row has more
    micro-tiles than threads."""
    rh = TILE
    while rh > 4:
        tiles = [(-(-min(rh, n - r0) // 4)) for r0 in range(0, n, rh)]
        if all(tr * (r0 // 4) + tr * (tr + 1) // 2 <= threads
               for tr, r0 in zip(tiles, range(0, n, rh))):
            break
        rh //= 2
    return rh


def lauum(a, n, order):
    """tiled_lauum: block rows from the top, each micro-tile held until the
    block row's barrier."""
    rh = lauum_rows(n)
    for r0 in range(0, n, rh):
        tr = -(-min(rh, n - r0) // 4)
        tiles = [(r0 + 4 * R, 4 * C) for R in range(tr) for C in range(r0 // 4 + R + 1)]
        assert len(tiles) <= THREADS
        held = []
        for i0, c0 in tiles[::order]:
            wa = lower0(a, i0, n, i0, i0 + 4)
            wb = lower0(a, i0, n, c0, c0 + 4)
            held.append((i0, c0, wa.T @ wb))
        for i0, c0, acc in held:
            for u in range(4):
                if i0 + u < n:
                    a[i0 + u, c0:c0 + 4] = acc[u]


def d2_raw(z):
    sq = (z * z).sum(axis=1)
    return (sq[:, None] + sq[None, :]) - 2.0 * z @ z.T


def system(n, f, seed, ragged=True, duplicated=False):
    """A task as map_task_grad sees it: features ph [N][F], mask, targets y,
    mean outputs mu; lengthscales, outputscale, diag_add."""
    rs = np.random.RandomState(seed)
    ph = rs.uniform(-2.0, 2.0, (n, f))
    msk = np.ones(n)
    if ragged:
        msk[n - 3:] = 0.0
        ph[n - 3:] = 0.0
    if duplicated:
        ph[1] = ph[0]
    mu = rs.randn(n) * msk
    y = mu + rs.randn(n) * msk
    sp_ls = 0.5 + rs.rand(f)
    sp_os = 0.5 + rs.rand()
    diag_add = 0.05 + 0.01 * rs.rand()
    return ph, msk, y, mu, sp_ls, sp_os, diag_add


def bordered(z, msk, sp_os, diag_add, jit):
    km = sp_os * np.exp(-0.5 * np.maximum(d2_raw(z), 0.0))
    return km * msk[:, None] * msk[None, :] + np.diag(np.where(msk > 0, diag_add + jit, 1.0))


def run_task(ph, msk, y, mu, sp_ls, sp_os, diag_add, w, order):
    """map_task_grad on the schedule: (level, L, z, K^-1 lower, alpha, d(mean),
    d(feature), hyp [F + 3])."""
    n, f = ph.shape
    z = ph / sp_ls
    r = (y - mu) * msk
    for level, jit in enumerate(JITTERS):
        a = padded(n + 1, n)
        kn = bordered(z, msk, sp_os, diag_add, jit)
        for i in range(n):
            a[i, :i + 1] = kn[i, :i + 1]
        a[n, :n] = r
        if factor(a, n, n + 1):
            break
    else:
        raise AssertionError("no level factors")
    L = lower0(a, 0, n, 0, n)
    zb = a[n, :n].copy()
    logs = invert(a, n, order)
    alpha = np.array([lower0(a, 0, n, 0, n)[k:, k] @ zb[k:] for k in range(n)])
    lauum(a, n, order)
    C = lower0(a, 0, n, 0, n)
    d_mean = w * alpha * msk
    # the score loop, a warp a row a, each (K^-1)_ab from the lower triangle
    d2 = d2_raw(z)
    kinv = np.where(np.arange(n)[None, :] <= np.arange(n)[:, None], C, C.T)
    s = 0.5 * w * (np.outer(alpha, alpha) - kinv)
    dkm = s * msk[:, None] * msk[None, :]
    km = sp_os * np.exp(-0.5 * np.maximum(d2, 0.0))
    dd2 = np.where(d2 > 0, -0.5 * dkm * km, 0.0)
    dz = 4.0 * (dd2.sum(axis=1)[:, None] * z - dd2 @ z)
    rowp_ls = dz * (-z)
    hyp = np.concatenate([rowp_ls.sum(axis=0) / sp_ls, [(dkm * km).sum(), np.diag(s) @ msk,
                          0.5 * w * (zb @ zb + 2.0 * sum(logs) + msk.sum() * np.log(2 * np.pi))]])
    return level, L, zb, C, alpha, d_mean, dz / sp_ls, hyp


SCHEDULE_CASES = [(n, f) for n in (9, 31, 32, 33, 200, 256, 257, 300, 512) for f in (1, 2, 3, 8)]


@pytest.mark.parametrize("n,f", SCHEDULE_CASES)
def test_map_schedule_matches_numpy(n, f):
    """B9's factor with its border row, inverse, alpha, K^-1 and loss term on
    a ragged task with F features and an outputscale, against numpy in
    float64, in both orders of each phase's micro-tiles; the block rows of
    the K^-1 product are 16 high past N = 280."""
    ph, msk, y, mu, sp_ls, sp_os, diag_add = system(n, f, 1000 + n + f)
    z = ph / sp_ls
    kn = bordered(z, msk, sp_os, diag_add, 0.0)
    L_ref = np.linalg.cholesky(kn)
    kinv = np.linalg.inv(kn)
    r = (y - mu) * msk
    tol = 1e-9 * np.abs(kinv).max()
    for order in (1, -1):
        level, L, zb, C, alpha, _, _, hyp = run_task(ph, msk, y, mu, sp_ls, sp_os, diag_add,
                                                     0.3, order)
        assert level == 0
        np.testing.assert_allclose(L, L_ref, atol=1e-11)
        np.testing.assert_allclose(zb, np.linalg.solve(L_ref, r), atol=1e-8)
        np.testing.assert_allclose(C, np.tril(kinv), atol=tol)
        np.testing.assert_allclose(alpha, kinv @ r, atol=tol * np.abs(r).sum())
        ref = 0.5 * 0.3 * (r @ kinv @ r + np.linalg.slogdet(kn)[1] + msk.sum() * np.log(2 * np.pi))
        np.testing.assert_allclose(hyp[-1], ref, rtol=1e-10)
    assert lauum_rows(n) == (TILE if n <= 280 else 16)


def test_map_schedule_escalates():
    """Two duplicated inputs with a diagonal short of the Gram matrix's null
    direction: level 0 meets a negative pivot, level 1 (1e-4 on the real
    rows) factors, and the loss is that of the level-1 system."""
    ph, msk, y, mu, sp_ls, sp_os, _ = system(40, 2, 5, duplicated=True)
    diag_add = -5e-5
    level, *_, hyp = run_task(ph, msk, y, mu, sp_ls, sp_os, diag_add, 1.0, 1)
    assert level == 1
    kn = bordered(ph / sp_ls, msk, sp_os, diag_add, 1e-4)
    r = (y - mu) * msk
    ref = 0.5 * (r @ np.linalg.solve(kn, r) + np.linalg.slogdet(kn)[1]
                 + msk.sum() * np.log(2 * np.pi))
    np.testing.assert_allclose(hyp[-1], ref, rtol=1e-7)


@pytest.mark.parametrize("n,f", [(33, 1), (40, 3), (70, 8)])
def test_map_score_chain_matches_autograd(n, f):
    """The score loop and the sums of map_task_grad on the schedule's K^-1
    against autograd of the plain MLL ``real_rows_mll`` in float64, with the
    softplus'd hyperparameters as leaves: d(w ll)/d(mean) = w alpha m,
    d(w ll)/d(feature) [N][F], d/d(softplus lengthscale) [F], the
    outputscale times d/d(softplus outputscale), d/d(noise) and -w ll."""
    ph, msk, y, mu, sp_ls, sp_os, diag_add = system(n, f, 60 + n)
    w = 0.3
    _, _, _, _, _, d_mean, d_feat, hyp = run_task(ph, msk, y, mu, sp_ls, sp_os, diag_add, w, 1)

    mean = torch.tensor(mu, requires_grad=True)
    feat = torch.tensor(ph, requires_grad=True)
    ls = torch.tensor(sp_ls, requires_grad=True)
    os_ = torch.tensor(sp_os, dtype=torch.float64, requires_grad=True)
    noise = torch.tensor(diag_add - 1e-6, dtype=torch.float64, requires_grad=True)
    zt = feat / ls
    sq = (zt * zt).sum(-1)
    d2 = (sq[:, None] + sq[None, :]) - 2.0 * zt @ zt.T
    K = os_ * torch.exp(-0.5 * torch.clamp(d2, min=0.0))
    m = torch.tensor(msk)
    ll = bg.real_rows_mll(mean, K, torch.tensor(y), noise, m) * m.sum()
    (w * ll).backward()
    # float64 rounding, relative to the largest entry
    for got, want in ((d_mean, mean.grad), (d_feat, feat.grad), (hyp[:f], ls.grad),
                      (hyp[f], sp_os * os_.grad), (hyp[f + 1], noise.grad)):
        want = np.asarray(want.detach().numpy() if torch.is_tensor(want) else want)
        np.testing.assert_allclose(got, want, atol=1e-10 * max(1.0, np.abs(want).max()))
    np.testing.assert_allclose(hyp[f + 2], -w * float(ll.detach()), rtol=1e-10)


def first_design_plan(t, n, d, f, mh, kh):
    """The first design's bign_plan, copied: the window the learners' gate
    was set by."""
    if not (t >= 1 and d >= 1 and 9 <= n <= 512 and 1 <= f <= 8 and mh and kh):
        return None
    p = layout_dim(mk.map_layout(d, f, mh, kh))
    groups, tpb = mk.task_groups(t)

    def smem(shared):
        r = tpb * n
        return 4 * (p + r * (d + 3 + f) + f + (f + 3) + 3 * n + n * (2 * f + 2) + 8 * n + 1
                    + (n * (n | 1) if shared else 0))

    shared = smem(True) <= SMEM_BYTES
    if not shared and smem(False) > SMEM_BYTES:
        return None
    scratch = 4 * groups * ((p + 1) + tpb * n * (sum(mh) + sum(kh)) + (0 if shared else n * n))
    return None if scratch > 2 ** 30 else (groups, tpb, shared)


NETS = [(8, 8), (16, 16, 16), (32, 32), (64, 64), (7, 7), (12, 20, 4), (128, 128), (256, 256),
        (512, 512)]


def test_bign_plan_keeps_the_window_and_fits():
    """Over a grid of T, N, D, F and nets: B9 takes exactly the shapes its first
    design took; every plan's block fits one Hopper block's shared memory at
    the most it can hold there (2 the packed matrix and the activations, 1
    the matrix, 0 neither; the parameters in shared memory unless nothing
    else fits); the score loop's rows fit the tiled scratch; the nets take
    the register tiles exactly when every width is a multiple of 4."""
    n_in = 0
    for n in (9, 31, 32, 33, 48, 100, 200, 201, 256, 257, 300, 400, 512):
        for nets in NETS:
            for f in (1, 2, 3, 8):
                for d in (1, 3):
                    for t in (1, 5, 129, 1152):
                        mh, kh = nets, nets[::-1]
                        old = first_design_plan(t, n, d, f, mh, kh)
                        plan = bg.bign_plan(t, n, d, f, mh, kh)
                        assert (plan is None) == (old is None), (t, n, d, f, nets)
                        if plan is None:
                            continue
                        n_in += 1
                        groups, tpb, shared, tiled, th_shared = plan
                        assert (groups, tpb) == old[:2]
                        p = layout_dim(mk.map_layout(d, f, mh, kh))
                        sum_h = sum(mh) + sum(kh)
                        fit = [bg.smem_bytes(n, d, f, p, sum_h, s, th_shared) <= SMEM_BYTES
                               for s in (0, 1, 2)] + [False]
                        assert fit[shared] and not fit[shared + 1], (t, n, d, f, nets, plan)
                        if not th_shared:
                            assert bg.smem_bytes(n, d, f, p, sum_h, 0, True) > SMEM_BYTES
                        assert tiled == all(h % 4 == 0 for h in mh + kh)
                        assert 4 * n * (2 * f + 2) <= bg.tiled_scratch_bytes(n, n + 1)
    assert n_in > 1000


def test_bign_plan_of_the_main_path():
    """map_t5_n200 (T=5, N=200, D=1, F=2, nets 32x32): one block a task, the
    packed matrix and both nets' activations in shared memory (228,924 of
    232,448 bytes), the register tiles; N=300 and 512 put the matrix in
    device memory; odd widths take the scalar passes; 1152 tasks, 9 a
    block."""
    assert bg.bign_plan(5, 200, 1, 2, (32, 32), (32, 32)) == (5, 1, 2, True, True)
    assert bg.smem_bytes(200, 1, 2, 2343, 128, 2) == 228924
    assert bg.bign_plan(5, 300, 2, 3, (16, 16, 16), (16, 16, 16))[2] == 0
    assert bg.bign_plan(5, 512, 1, 2, (32, 32), (32, 32))[2] == 0
    assert bg.bign_plan(5, 200, 1, 2, (7, 7), (7, 7))[3] is False
    assert bg.bign_plan(1152, 64, 1, 2, (32, 32), (32, 32))[:2] == (128, 9)


def test_bign_smem_mirror_counts_the_layout():
    """smem_bytes is the source's smem_floats: the tiled matrix's area
    (scratch, and the packed rows of N + 1 rows at placement >= 1), the
    parameters, N (D + F + 7) + 2F + 20 floats of rows, vectors and sums and,
    at placement 2, both nets' activations [sum_h][N | 1]."""
    n, d, f, p, sum_h = 200, 1, 2, 2343, 128
    scratch = TILE * TILE + 4 + TILE * round4(n + 1 - TILE)
    packed = sum(round4(i + 1) for i in range(n + 1))
    vec = n * (d + f + 7) + 2 * f + 4 + 16
    acts = sum_h * (n | 1)
    assert bg.smem_bytes(n, d, f, p, sum_h, 2) == 4 * (scratch + packed + p + vec + acts)
    assert bg.smem_bytes(n, d, f, p, sum_h, 1) == 4 * (scratch + packed + p + vec)
    assert bg.smem_bytes(n, d, f, p, sum_h, 0) == 4 * (scratch + p + vec)
    assert bg.smem_bytes(n, d, f, p, sum_h, 0, False) == 4 * (scratch + vec)
    shapes = bg.scratch_shapes((128, 9, 0, True, False), n, p, sum_h)
    assert shapes == {"gbuf": (128, p + 1), "gtask": (128, p + 1), "th_dev": (128, p),
                      "act": (128, sum_h * (n | 1)), "work": (128, n, n)}


def map_window(t, n, d, f, mh, kh):
    """The window the learners' gate was set by: the first design's block
    of ``task_groups`` tasks in shared memory (a copy of its formula)."""
    if not (t >= 1 and d >= 1 and 1 <= n <= 8 and 1 <= f <= 8 and mh and kh):
        return False
    p = layout_dim(mk.map_layout(d, f, mh, kh))
    _, tpb = mk.task_groups(t)
    r = tpb * n
    return 4 * (p + r * (sum(mh) + sum(kh)) + r * (d + 3 + f) + f + tpb * (f + 3)) <= SMEM_BYTES


@pytest.mark.parametrize("nets", NETS[:7], ids=str)
def test_map_plan_covers_the_window(nets):
    """B6 over a grid of T (1-3000), N (1-8), D, F and nets: the window is
    unchanged; every shape in it gets a plan: one cluster of the first size
    of CLUSTER_SIZES with no more CTAs than tasks whose CTA fits one Hopper
    block's shared memory, or, where none does, the first design's grid;
    register tiles exactly when every width is a multiple of 4. Nets of 128
    units (P about 34k) do not fit a CTA beside their partial gradient and
    keep the grid."""
    n_cluster = n_grid = 0
    for t in (1, 2, 3, 5, 7, 20, 64, 128, 129, 200, 400, 1000, 3000):
        for n in (1, 3, 5, 8):
            for f in (1, 2, 8):
                for d in (1, 3):
                    mh, kh = nets, nets[::-1]
                    fits = mk.fused_map_fits(t, n, d, f, mh, kh)
                    assert fits == map_window(t, n, d, f, mh, kh), (t, n, d, f, nets)
                    if not fits:
                        continue
                    c, tiled = mk.map_plan(t, n, d, f, mh, kh)
                    assert tiled == all(h % 4 == 0 for h in mh + kh)
                    p = layout_dim(mk.map_layout(d, f, mh, kh))
                    sizes = [s for s in mk.CLUSTER_SIZES
                             if s <= t and mk.cluster_smem_bytes(t, n, d, f, p, sum(mh) + sum(kh),
                                                                 s) <= SMEM_BYTES]
                    assert c == (sizes[0] if sizes else 0), (t, n, d, f, nets, c)
                    n_cluster += c > 0
                    n_grid += c == 0
    assert n_cluster + n_grid > 100 and n_grid > 0
    # a CTA holds the parameters and its partial gradient: nets of 128 units keep the grid
    assert (n_cluster > 100) == (max(nets) <= 64)


@pytest.mark.parametrize("c", [1, 2, 3, 4, 8, 16])
def test_cluster_task_groups_and_slices_cover_once(c):
    """The CTAs' task groups cover every task once, none larger than
    ceil(T / C) (the rows' height); the slices of P cover every coordinate
    once (csrc/cluster_util.cuh)."""
    from meta_learning_pacoh_torch.ops.cuda.fused_svgd_kernel import task_lo

    for t in range(c, 61):
        groups = [range(task_lo(r, t, c), task_lo(r + 1, t, c)) for r in range(c)]
        assert [i for g in groups for i in g] == list(range(t))
        assert max(len(g) for g in groups) == -(-t // c)
    for p in (1, 5, 578, 2343, 9999):
        sl = mk.slice_len(p, c)
        assert sl % 4 == 0
        cover = [i for r in range(c) for i in range(min(p, r * sl), min(p, (r + 1) * sl))]
        assert cover == list(range(p))


def test_cluster_plan_of_the_demo():
    """The demo (T=20, N=5, D=1, F=2, nets 32x32, P=2343): one cluster of the
    plan's first size, 3 tasks and 15 rows a CTA at C=8; a CTA's bytes as
    csrc/fused_map.cu lays them out; nets (7, 7) take the scalar passes;
    1000 tasks of 8 points keep the first design's grid."""
    assert mk.map_plan(20, 5, 1, 2, (32, 32), (32, 32)) == (mk.CLUSTER_SIZES[0], True)
    p, sum_h, c = 2343, 128, 8
    tmax, rmax = 3, 15
    want = 2 * p + 1 + 2 * 296 + sum_h * 15 + rmax * (2 + 5 + 2) + tmax * 7 + 2 + 4
    assert mk.slice_len(p, c) == 296
    assert mk.cluster_smem_bytes(20, 5, 1, 2, p, sum_h, c) == 4 * want
    assert mk.map_plan(20, 5, 1, 2, (7, 7), (7, 7))[1] is False
    assert mk.map_plan(1000, 8, 1, 2, (32, 32), (32, 32))[0] == 0
    assert mk.map_plan(20, 5, 1, 2, (32, 32), (32, 32), cluster=16) == (16, True)
