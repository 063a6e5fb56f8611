"""The cluster plan of the fused SVGD (B2) and VI (B7) kernels, on the CPU.

The kernels run one thread-block cluster of C CTAs a particle or sample;
CTA r owns a contiguous group of tasks and a slice of P, and walks its
tasks in tiles where their rows do not fit beside the rest. Here, without a
card: the kernels' window does not depend on T (a shape that fits at one
task fits at every T) and holds every shape of the one-block kernel's
window (a copy of its formula below); the plan's CTAs fit in shared memory
and its clusters are co-resident as the Python mirror reckons it; wherever
the old window held, the plan is the untiled plan of before (a copy below);
the task groups, the tiles and the slices cover each task and coordinate
once; and the split score, summed in rank order and over a CTA's tiles in
order, is the whole score (float64, within 1e-12).
"""

import numpy as np
import pytest
import torch

from meta_learning_pacoh_torch.models.gp_base import gp_prior_mll_batch
from meta_learning_pacoh_torch.models.random_gp import meta_log_prob
from meta_learning_pacoh_torch.ops.cuda import fused_svgd_kernel as fk
from meta_learning_pacoh_torch.ops.cuda import fused_vi_kernel as vk

SMEM = 232448  # shared memory one Hopper block can use
HIDDENS = [(8, 8), (16, 16), (32, 32), (64, 64), (16, 16, 16), (32, 32, 32), (64, 64, 64),
           (7,), (48, 48, 48, 48), (32, 16)]
COUNTS = (1, 2, 3, 5, 10, 16, 31, 32, 33)  # K or S
TASKS = (1, 2, 3, 5, 7, 20, 64, 200, 400, 1000)
POINTS = (1, 2, 3, 5, 8, 9)


def window_svgd(k, t, n, d, hidden):
    """The window of the one-block kernel the learners' gate was set by."""
    hidden = tuple(hidden)
    if not (1 <= k <= 32 and 1 <= n <= 8 and len(hidden) >= 1 and len(set(hidden)) == 1):
        return False
    p = fk.fused_prior(d, hidden, 1.0, 1.0).dim
    m, h, n_layers = t * n, hidden[0], len(hidden)
    return 4 * (2 * p + 2 * n_layers * m * h + m * (d + 4) + 2 * t + k * k + k + 8) <= SMEM


def window_vi(s, t, n, d, hidden):
    hidden = tuple(hidden)
    if not (1 <= s <= 32 and 1 <= n <= 8 and len(hidden) >= 1 and len(set(hidden)) == 1):
        return False
    p = fk.fused_prior(d, hidden, 1.0, 1.0).dim
    m, h, n_layers = t * n, hidden[0], len(hidden)
    return 4 * (8 * p + 2 * n_layers * m * h + m * (d + 4) + 3 * t + 32 + 8) <= SMEM


def untiled_plan_svgd(k, t, n, d, hidden):
    """B2's plan with every CTA's rows whole, as it was before tiles."""
    p, h, n_layers = fk.fused_prior(d, hidden, 1.0, 1.0).dim, hidden[0], len(hidden)
    pairs = k * (k - 1) // 2
    for c in fk.CLUSTER_SIZES:
        if c > t or k > fk.RESIDENT_CLUSTERS[c]:
            continue
        for hs in dict.fromkeys((h | 1, h)):
            rmax = -(-t // c) * n
            rest = 4 * (2 * p + (n_layers + 1) * 2 * rmax * hs + rmax * (d + 4) + 2 * -(-t // c)
                        + 3 * pairs + max(pairs, 512) + k + 8 + 4 * n_layers + 6)
            room = (SMEM - rest) // (8 * k)
            sl = fk.slice_len(p, c)
            if fk.stash_pitch(sl) <= room:
                return c, hs, sl
            if room >= 32:
                return c, hs, (room - 28) // 4 * 4
            if room >= 1:
                return c, hs, room - 1 + room % 2
    return None


def untiled_plan_vi(s, t, n, d, hidden):
    """B7's plan with every CTA's rows whole, as it was before tiles."""
    p, h, n_layers = fk.fused_prior(d, hidden, 1.0, 1.0).dim, hidden[0], len(hidden)
    for c in fk.CLUSTER_SIZES:
        if c > t or s > fk.RESIDENT_CLUSTERS[c]:
            continue
        for hs in dict.fromkeys((h | 1, h)):
            rmax = -(-t // c) * n
            if 4 * (2 * p + (n_layers + 1) * 2 * rmax * hs + rmax * (d + 4) + 3 * -(-t // c)
                    + 6 * fk.slice_len(p, c) + 32 + 8 + 4 * n_layers + 6) <= SMEM:
                return c, hs
    return None


def tiles(t0, nt, tile):
    """The tiles of a CTA's tasks [t0, t0 + nt) in csrc/cluster_score.cuh's
    n_tiles / tile_rows: tile j holds [t0 + j tile, t0 + min((j + 1) tile, nt))."""
    n = 1 if nt <= tile else -(-nt // tile)
    return [range(t0 + j * tile, t0 + min((j + 1) * tile, nt)) for j in range(n)]


def grid(hidden):
    for k in COUNTS:
        for t in TASKS:
            for n in POINTS:
                for d in (1, 2, 3):
                    yield k, t, n, d, hidden


@pytest.mark.parametrize("hidden", HIDDENS, ids=str)
def test_window_is_unchanged(hidden):
    """fused_svgd_fits and fused_vi_fits do not depend on T (at every T of
    the grid they give their answer at T=1) and take every shape the
    one-block kernel took, at every K or S in 1..33, N in 1..9 and D in
    1..3."""
    n_in = 0
    for k, t, n, d, h in grid(hidden):
        assert fk.fused_svgd_fits(k, t, n, d, h) == fk.fused_svgd_fits(k, 1, n, d, h), (k, t, n, d)
        assert vk.fused_vi_fits(k, t, n, d, h) == vk.fused_vi_fits(k, 1, n, d, h), (k, t, n, d)
        assert fk.fused_svgd_fits(k, t, n, d, h) or not window_svgd(k, t, n, d, h), (k, t, n, d)
        assert vk.fused_vi_fits(k, t, n, d, h) or not window_vi(k, t, n, d, h), (k, t, n, d)
        n_in += fk.fused_svgd_fits(k, t, n, d, h) and not window_svgd(k, t, n, d, h)
    assert n_in > 0 or len(set(hidden)) > 1


@pytest.mark.parametrize("hidden", HIDDENS, ids=str)
def test_plan_fits_every_shape_of_the_window(hidden):
    """For every shape the kernels take, at every T up to 1,000, the plan's
    CTA (its rows those of a tile) fits in 232,448 bytes, its K (S)
    clusters of C fit the mirror's co-resident count, C is no more than T,
    the row stride is H or H + 1 and a tile at most a CTA's tasks; wherever
    the one-block kernel's window held, the staging chunk is at most a slice
    and the plan is the untiled plan of before, one tile a CTA."""
    for k, t, n, d, h in grid(hidden):
        p = fk.fused_prior(d, h, 1.0, 1.0).dim if len(set(h)) == 1 else None
        if fk.fused_svgd_fits(k, t, n, d, h):
            c, hs, ch, tile = fk.cluster_plan(k, t, n, d, h)
            assert fk.smem_bytes(k, t, n, d, h, p, c, hs, ch, tile) <= SMEM
            assert k <= fk.RESIDENT_CLUSTERS[c] and c <= t and hs in (h[0], h[0] + 1)
            assert 1 <= ch and fk.stash_pitch(ch) >= ch and 1 <= tile <= -(-t // c)
            if window_svgd(k, t, n, d, h):
                assert ch <= fk.slice_len(p, c)
                assert (c, hs, ch, tile) == (*untiled_plan_svgd(k, t, n, d, h), -(-t // c))
        if vk.fused_vi_fits(k, t, n, d, h):
            c, hs, tile = vk.cluster_plan(k, t, n, d, h)
            assert vk.smem_bytes(t, n, d, h, p, c, hs, tile) <= SMEM
            assert k <= fk.RESIDENT_CLUSTERS[c] and c <= t and hs in (h[0], h[0] + 1)
            assert 1 <= tile <= -(-t // c)
            if window_vi(k, t, n, d, h):
                assert (c, hs, tile) == (*untiled_plan_vi(k, t, n, d, h), -(-t // c))


def test_plan_of_the_main_path():
    """sin_20 (K = S = 10, T=20, N=5, D=1, 32x32): clusters of 8, 80 CTAs,
    the whole slice staged, one tile a CTA; K = S = 32 falls back to
    clusters of 2 (the card holds 15 of 8, 22 of 5, 30 of 4); sin_320 (T=320)
    still untiled, 512 tasks in tiles (46 tasks a tile for B2 beside the
    staged slice, 50 for B7)."""
    assert fk.cluster_plan(10, 20, 5, 1, (32, 32)) == (8, 33, 292, 3)
    assert vk.cluster_plan(10, 20, 5, 1, (32, 32)) == (8, 33, 3)
    assert fk.cluster_plan(32, 20, 5, 1, (32, 32))[0] == 2
    assert vk.cluster_plan(32, 20, 5, 1, (32, 32))[0] == 2
    assert fk.cluster_plan(10, 1, 5, 1, (32, 32))[0] == 1  # one task: one CTA
    assert fk.cluster_plan(32, 20, 5, 1, (32, 32), cluster=8)[0] == 8  # forced, not checked
    assert fk.cluster_plan(10, 320, 5, 1, (32, 32)) == (8, 33, 292, 40)
    assert vk.cluster_plan(10, 320, 5, 1, (32, 32)) == (8, 33, 40)
    assert fk.cluster_plan(10, 512, 5, 1, (32, 32)) == (8, 33, 292, 46)
    assert vk.cluster_plan(10, 512, 5, 1, (32, 32)) == (8, 33, 50)


@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 8])
def test_task_groups_and_slices_cover_once(c):
    """The CTAs' task groups cover every task once, none larger than
    ceil(T / C) (the slots' height); the slices of P cover every coordinate
    once."""
    for t in range(1, 61):
        groups = [range(fk.task_lo(r, t, c), fk.task_lo(r + 1, t, c)) for r in range(c)]
        assert [i for g in groups for i in g] == list(range(t))
        assert max(len(g) for g in groups) == -(-t // c)
    for p in (1, 5, 578, 2308, 2372, 9999):
        sl = fk.slice_len(p, c)
        assert sl % 4 == 0
        cover = [i for r in range(c) for i in range(min(p, r * sl), min(p, (r + 1) * sl))]
        assert cover == list(range(p))


@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 8])
def test_split_score_is_the_whole_score(c):
    """float64: the plain MLL score (the gradient of sum_t w_t MLL_t, no
    hyper-prior term) summed over each CTA's task group in rank order equals
    the whole plain MLL score within 1e-12 (7 ragged tasks; with C = 8 one CTA
    has none)."""
    rs = np.random.RandomState(40 + c)
    t, n, d, hidden, k = 7, 5, 1, (8, 8), 3
    x = rs.uniform(-2.0, 2.0, (t, n, d))
    y = np.sin(2.0 * x[..., 0]) + 0.1 * rs.randn(t, n)
    mask = np.ones((t, n))
    mask[2, 3:] = 0.0
    x[mask == 0], y[mask == 0] = 0.0, 0.0
    hp = fk.fused_prior(d, hidden, 0.5, 3.0)
    x, y, mask = (torch.from_numpy(a) for a in (x, y, mask))
    theta = (hp.loc.double() + hp.scale.double()
             * torch.from_numpy(rs.randn(k, hp.dim))).requires_grad_(True)
    whole, = torch.autograd.grad(meta_log_prob(hp, 0.0, theta, x, y, mask).sum(), theta)
    sizes = mask.sum(-1)
    harmonic = 1.0 / torch.mean(1.0 / sizes)
    pre = harmonic / (harmonic + t)
    split = torch.zeros_like(whole)
    for r in range(c):
        g = slice(fk.task_lo(r, t, c), fk.task_lo(r + 1, t, c))
        if g.stop == g.start:
            continue
        part = pre * gp_prior_mll_batch(hp.cfg, hp.unravel(theta), x[g], y[g], mask[g]).sum()
        split = split + torch.autograd.grad(part, theta)[0]
    assert float((split - whole).abs().max()) <= 1e-12 * max(1.0, float(whole.abs().max()))
    assert float(whole.abs().max()) > 1e-3


@pytest.mark.parametrize("tile", [1, 2, 3, 4, 7, 8])
def test_tiles_cover_each_task_once(tile):
    """Every CTA's tiles of ``tile`` tasks cover its tasks once, in order,
    none larger than the tile (the slots' height) and only the last shorter."""
    for t in (1, 2, 7, 20, 61, 512):
        for c in (1, 2, 5, 8):
            for r in range(c):
                t0, nt = fk.task_lo(r, t, c), fk.task_lo(r + 1, t, c) - fk.task_lo(r, t, c)
                parts = tiles(t0, nt, tile)
                assert [i for g in parts for i in g] == list(range(t0, t0 + nt))
                assert all(len(g) == tile for g in parts[:-1]) and len(parts[-1]) <= tile


@pytest.mark.parametrize("tile", [1, 2, 3, 4])
def test_tiled_score_is_the_whole_score(tile):
    """float64: the plain MLL score of each CTA's task group (C = 2 over 9
    ragged tasks) formed tile by tile, each tile's partial added in order,
    then the groups summed in rank order, equals the whole plain MLL score
    within 1e-12."""
    rs = np.random.RandomState(50 + tile)
    t, n, d, hidden, k, c = 9, 5, 1, (8, 8), 3, 2
    x = rs.uniform(-2.0, 2.0, (t, n, d))
    y = np.sin(2.0 * x[..., 0]) + 0.1 * rs.randn(t, n)
    mask = np.ones((t, n))
    mask[4, 2:] = 0.0
    x[mask == 0], y[mask == 0] = 0.0, 0.0
    hp = fk.fused_prior(d, hidden, 0.5, 3.0)
    x, y, mask = (torch.from_numpy(a) for a in (x, y, mask))
    theta = (hp.loc.double() + hp.scale.double()
             * torch.from_numpy(rs.randn(k, hp.dim))).requires_grad_(True)
    whole, = torch.autograd.grad(meta_log_prob(hp, 0.0, theta, x, y, mask).sum(), theta)
    sizes = mask.sum(-1)
    harmonic = 1.0 / torch.mean(1.0 / sizes)
    pre = harmonic / (harmonic + t)
    split = torch.zeros_like(whole)
    for r in range(c):
        t0 = fk.task_lo(r, t, c)
        group = torch.zeros_like(whole)
        for g in tiles(t0, fk.task_lo(r + 1, t, c) - t0, tile):
            g = slice(g.start, g.stop)
            part = pre * gp_prior_mll_batch(hp.cfg, hp.unravel(theta), x[g], y[g], mask[g]).sum()
            group = group + torch.autograd.grad(part, theta)[0]
        split = split + group
    assert float((split - whole).abs().max()) <= 1e-12 * max(1.0, float(whole.abs().max()))
    assert float(whole.abs().max()) > 1e-3
