"""The cluster plan of the fused SVGD (B2) and VI (B7) kernels, on the CPU.

The kernels run one thread-block cluster of C CTAs a particle or sample;
CTA r owns a contiguous group of tasks and a slice of P. Here, without a
card: the kernels' window is the one the learners' dispatch was set by (a
copy of its formula below), the plan's CTAs fit in shared memory and its
clusters are co-resident as the Python mirror reckons it, the task groups
and slices cover each task and coordinate once, and the split score,
summed in rank order, is the whole score (float64, within 1e-12).
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


def grid(hidden):
    for k in COUNTS:
        for t in TASKS:
            for n in POINTS:
                for d in (1, 2, 3):
                    yield k, t, n, d, hidden


@pytest.mark.parametrize("hidden", HIDDENS, ids=str)
def test_window_is_unchanged(hidden):
    """fused_svgd_fits and fused_vi_fits take exactly the shapes they took
    with one block a particle or sample, at every K or S in 1..33, T, N in
    1..9 and D in 1..3."""
    n_in = 0
    for k, t, n, d, h in grid(hidden):
        assert fk.fused_svgd_fits(k, t, n, d, h) == window_svgd(k, t, n, d, h), (k, t, n, d, h)
        assert vk.fused_vi_fits(k, t, n, d, h) == window_vi(k, t, n, d, h), (k, t, n, d, h)
        n_in += window_svgd(k, t, n, d, h)
    assert n_in > 0 or len(set(hidden)) > 1


@pytest.mark.parametrize("hidden", HIDDENS, ids=str)
def test_plan_fits_every_shape_of_the_window(hidden):
    """For every shape in the window the plan's CTA fits in 232,448 bytes,
    its K (S) clusters of C fit the mirror's co-resident count, C is no more
    than T, the row stride is H or H + 1 and the staging chunk at most a
    slice."""
    for k, t, n, d, h in grid(hidden):
        p = fk.fused_prior(d, h, 1.0, 1.0).dim if len(set(h)) == 1 else None
        if window_svgd(k, t, n, d, h):
            c, hs, ch = fk.cluster_plan(k, t, n, d, h)
            assert fk.smem_bytes(k, t, n, d, h, p, c, hs, ch) <= SMEM
            assert k <= fk.RESIDENT_CLUSTERS[c] and c <= t and hs in (h[0], h[0] + 1)
            assert 1 <= ch <= fk.slice_len(p, c) and fk.stash_pitch(ch) >= ch
        if window_vi(k, t, n, d, h):
            c, hs = vk.cluster_plan(k, t, n, d, h)
            assert vk.smem_bytes(t, n, d, h, p, c, hs) <= SMEM
            assert k <= fk.RESIDENT_CLUSTERS[c] and c <= t and hs in (h[0], h[0] + 1)


def test_plan_of_the_main_path():
    """sin_20 (K = S = 10, T=20, N=5, D=1, 32x32): clusters of 8, 80 CTAs,
    the whole slice staged; K = S = 32 falls back to clusters of 2 (the card
    holds 15 of 8, 22 of 5, 30 of 4)."""
    assert fk.cluster_plan(10, 20, 5, 1, (32, 32)) == (8, 33, 292)
    assert vk.cluster_plan(10, 20, 5, 1, (32, 32)) == (8, 33)
    assert fk.cluster_plan(32, 20, 5, 1, (32, 32))[0] == 2
    assert vk.cluster_plan(32, 20, 5, 1, (32, 32))[0] == 2
    assert fk.cluster_plan(10, 1, 5, 1, (32, 32))[0] == 1  # one task: one CTA
    assert fk.cluster_plan(32, 20, 5, 1, (32, 32), cluster=8)[0] == 8  # forced, not checked


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
