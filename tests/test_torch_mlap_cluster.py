"""The cluster plan of the fused PACOH-MLAP kernel (B8), on the CPU.

The kernel runs one thread-block cluster of C CTAs a sample; CTA r owns a
contiguous group of tasks (their rows and their posteriors) and a slice of
P; where a CTA's tasks do not fit in its shared memory, the tiled kernel
keeps the posteriors in device memory and walks the tasks in tiles. Here,
without a card: the kernel's window does not depend on T and holds every
shape of the one-block kernel's window (a copy of its formula below); the
plan's CTAs fit in shared memory and its clusters are co-resident as the
Python mirror reckons it; wherever the old window held, the plan is the
untiled plan of before (a copy below); the task groups and slices cover
each task and coordinate once; and, in float64, the CTAs' partial scores
summed in rank order (and a CTA's over its tiles in order) are the whole
score, and the per-task posteriors' gradients computed over each CTA's task
group alone are the whole's (within 1e-12).
"""

import numpy as np
import pytest
import torch

from meta_learning_pacoh_torch.ops.cuda import fused_mlap_kernel as mk
from meta_learning_pacoh_torch.ops.cuda import fused_svgd_kernel as fk

import chip_smoke

SMEM = 232448  # shared memory one Hopper block can use
HIDDENS = [(8, 8), (16, 16), (32, 32), (48, 48), (16, 16, 16), (32, 32, 32), (7,),
           (40, 40, 40), (24, 24, 24, 24), (800,), (32, 16)]
SAMPLES = (1, 3, 5, 16, 32, 33)
TASKS = (1, 2, 3, 5, 7, 20, 64, 200, 400, 1000)
POINTS = (1, 2, 3, 5, 7, 8, 9)


def window(s, t, n, d, hidden):
    """The window of the one-block kernel the learners' gate was set by."""
    hidden = tuple(hidden)
    if not (1 <= s <= 32 and 1 <= n <= 8 and len(hidden) >= 1 and len(set(hidden)) == 1):
        return False
    p = fk.fused_prior(d, hidden, 1.0, 1.0).dim
    m, h, n_layers = t * n, hidden[0], len(hidden)
    return 4 * (8 * p + 3 * m * (n + 1) + 2 * n_layers * m * h + m * (d + 4) + 8 * t + 48) <= SMEM


def untiled_bytes(t, n, d, hidden, p, c, hs):
    """A CTA's shared memory with its tasks' rows and posteriors whole."""
    tmax, n_layers = -(-t // c), len(hidden)
    rmax = tmax * n
    return 4 * (2 * p + (n_layers + 1) * 2 * rmax * hs + rmax * (d + 4) + 4 * tmax
                + 3 * rmax * (n + 1) + 6 * fk.slice_len(p, c) + 40 + 16 + 4 * n_layers + 6)


def untiled_plan(s, t, n, d, hidden):
    """B8's plan with every CTA's tasks whole, as it was before tiles."""
    p, h = fk.fused_prior(d, hidden, 1.0, 1.0).dim, hidden[0]
    sizes = [c for c in fk.CLUSTER_SIZES if c <= t] + [c for c in reversed(fk.CLUSTER_SIZES)
                                                       if c > t]
    for c in [c for c in sizes if s <= fk.RESIDENT_CLUSTERS[c]]:
        for hs in dict.fromkeys((h | 1, h)):
            if untiled_bytes(t, n, d, hidden, p, c, hs) <= SMEM:
                return c, hs
    return None


def grid(hidden):
    for s in SAMPLES:
        for t in TASKS:
            for n in POINTS:
                for d in (1, 3):
                    yield s, t, n, d, hidden


@pytest.mark.parametrize("hidden", HIDDENS, ids=str)
def test_window_is_unchanged_and_the_plan_fits_it(hidden):
    """fused_mlap_fits does not depend on T (at every T of the grid it gives
    its answer at T=1) and takes every shape the one-block kernel took; for
    each shape it takes the plan's CTA (a tile's rows where tiled) fits in
    232,448 bytes, its S clusters of C fit the mirror's co-resident count,
    the row stride is H or H + 1, a tile is at most a CTA's tasks, C is no
    more than T unless no such size fits untiled (a task or two of a wide
    net: (40, 40, 40) and (800,) at T=1 hold such shapes), and wherever the
    old window held the plan is the untiled plan of before."""
    n_in = n_out = 0
    for s, t, n, d, h in grid(hidden):
        fits = mk.fused_mlap_fits(s, t, n, d, h)
        assert fits == mk.fused_mlap_fits(s, 1, n, d, h), (s, t, n, d, h)
        assert fits or not window(s, t, n, d, h), (s, t, n, d, h)
        if not fits:
            continue
        n_in += 1
        p = fk.fused_prior(d, h, 1.0, 1.0).dim
        c, hs, tile = mk.cluster_plan(s, t, n, d, h)
        assert mk.smem_bytes(t, n, d, h, p, c, hs, tile) <= SMEM
        assert s <= fk.RESIDENT_CLUSTERS[c] and hs in (h[0], h[0] + 1)
        assert 1 <= tile <= -(-t // c)
        if c > t:
            assert all(s > fk.RESIDENT_CLUSTERS[k]
                       or min(untiled_bytes(t, n, d, h, p, k, x) for x in (h[0], h[0] | 1)) > SMEM
                       for k in fk.CLUSTER_SIZES if k <= t), (s, t, n, d, h)
        if window(s, t, n, d, h):
            assert (c, hs, tile) == (*untiled_plan(s, t, n, d, h), -(-t // c))
        else:
            n_out += 1
    assert n_in > 0 or len(set(hidden)) > 1
    assert n_out > 0 or len(set(hidden)) > 1


def test_plan_of_the_main_path():
    """mlap (S=5, T=20, N=5, D=1, 32x32): clusters of 8, 40 CTAs; bench.py's
    meta-test row (T=5): clusters of 5; phase 2's odd shape (S=3, T=7, N=7,
    D=2, (16,16,16)): clusters of 5; S=32: clusters of 2 (the card holds 15
    of 8, 22 of 5, 30 of 4); the MLAP CLI's 200 test tasks still untiled, 512
    tasks in tiles of 50."""
    assert mk.cluster_plan(5, 20, 5, 1, (32, 32)) == (8, 33, 3)
    assert mk.cluster_plan(5, 5, 5, 1, (32, 32)) == (5, 33, 1)
    assert mk.cluster_plan(3, 7, 7, 2, (16, 16, 16)) == (5, 17, 2)
    assert mk.cluster_plan(32, 20, 5, 1, (32, 32))[0] == 2
    assert mk.cluster_plan(5, 1, 5, 1, (32, 32))[0] == 1  # one task: one CTA
    assert mk.cluster_plan(32, 20, 5, 1, (32, 32), cluster=8)[0] == 8  # forced, not checked
    assert mk.cluster_plan(5, 200, 5, 1, (32, 32)) == (8, 33, 25)
    assert mk.cluster_plan(5, 512, 5, 1, (32, 32)) == (8, 33, 50)


@pytest.mark.parametrize("s,t,n,d,hidden", [(5, 20, 5, 1, (32, 32)), (5, 5, 5, 1, (32, 32)),
                                            (3, 7, 7, 2, (16, 16, 16)), (5, 1, 8, 3, (40, 40, 40))])
def test_plan_groups_and_slices_cover_once(s, t, n, d, hidden):
    """At the main path's shapes and at each forced C, the CTAs' task groups
    (rows t0 N .. (t0 + nt) N of the q-side scratch) cover every task once and
    the slices of P every coordinate once."""
    p = fk.fused_prior(d, hidden, 1.0, 1.0).dim
    for c in (mk.cluster_plan(s, t, n, d, hidden)[0],) + fk.CLUSTER_SIZES:
        groups = [range(fk.task_lo(r, t, c), fk.task_lo(r + 1, t, c)) for r in range(c)]
        assert [i for g in groups for i in g] == list(range(t))
        assert max(len(g) for g in groups) == -(-t // c)
        sl = fk.slice_len(p, c)
        cover = [i for r in range(c) for i in range(min(p, r * sl), min(p, (r + 1) * sl))]
        assert cover == list(range(p))


def _problem(rs, t, n, d, hidden):
    """A float64 MLAP problem of t tasks, the second two points short, from
    chip_smoke.py's well-conditioned state (the kernel's inputs)."""
    sizes = [n] * t
    sizes[1] = n - 2
    tasks = chip_smoke.conditioned_tasks(rs, t, n, d, sizes)
    x = np.zeros((t, n, d))
    y, mask = np.zeros((t, n)), np.zeros((t, n))
    for i, (xi, yi) in enumerate(tasks):
        x[i, :len(yi)], y[i, :len(yi)], mask[i, :len(yi)] = xi, yi, 1.0
    hp = mk._prior_on(d, hidden, 0.5, 3.0, torch.device("cpu"))
    state = chip_smoke.conditioned_params(hp, mask, -1.0, rs)
    params = {k: torch.from_numpy(np.asarray(v, np.float64))
              for k, v in {**state["hyper_post"], **state}.items() if k != "hyper_post"}
    return (*(torch.from_numpy(a) for a in (x, y, mask)), params, hp)


@pytest.mark.parametrize("c", [1, 2, 4, 5, 8])
def test_split_score_is_the_whole_score(c, monkeypatch):
    """float64: the sample scores of the plain version (the nets' backward of
    the cotangents d(mean), d(feature) scaled by gamma_t) with the
    cotangents of each CTA's task group alone, summed in rank order, equal
    the whole scores within 1e-12 (7 ragged tasks; with C = 8 one CTA has
    none)."""
    t, n, d, hidden, s = 7, 5, 1, (8, 8), 3
    rs = np.random.RandomState(60 + c)
    x, y, mask, params, hp = _problem(rs, t, n, d, hidden)
    eps = torch.from_numpy(rs.randn(s, hp.dim))
    counts = torch.tensor([2.0, 0.0, 1.0, 1.0, 0.0, 2.0, 1.0], dtype=torch.float64)
    grad = torch.autograd.grad
    seen = {}

    def split_grad(outputs, inputs, grad_outputs, **kw):
        whole = grad(outputs, inputs, grad_outputs, retain_graph=True)
        split = torch.zeros_like(whole[0])
        for r in range(c):
            g = torch.zeros(t, dtype=torch.float64)
            g[fk.task_lo(r, t, c):fk.task_lo(r + 1, t, c)] = 1.0
            cot = [v * g.view(1, t, *([1] * (v.dim() - 2))) for v in grad_outputs]
            split = split + grad(outputs, inputs, cot, retain_graph=True)[0]
        seen["whole"], seen["split"] = whole[0], split
        return whole

    monkeypatch.setattr(torch.autograd, "grad", split_grad)
    mk.mlap_loss_and_grads(params, eps, counts, x, y, mask, hp, task_kl_weight=1.0,
                           meta_kl_weight=1e-3, delta=0.1)
    whole, split = seen["whole"], seen["split"]
    assert whole.shape == (s, hp.dim) and float(whole.abs().max()) > 1e-3
    assert float((split - whole).abs().max()) <= 1e-12 * float(whole.abs().max())


@pytest.mark.parametrize("c", [1, 2, 4, 5, 8])
def test_split_posterior_reduction_is_the_whole(c):
    """float64, in meta-test mode (u_t = 1): the per-task posteriors'
    gradients, and their bound terms, computed by each CTA over its own
    task group alone (the reduction over the S samples of its own rows of
    the q-side scratch) equal the rows of the whole within 1e-12."""
    t, n, d, hidden, s = 7, 5, 1, (8, 8), 3
    rs = np.random.RandomState(70 + c)
    x, y, mask, params, hp = _problem(rs, t, n, d, hidden)
    eps = torch.from_numpy(rs.randn(s, hp.dim))
    kw = dict(task_kl_weight=1.0, meta_kl_weight=1e-3, delta=0.1, n_tasks=t, meta_test=True)
    loss, whole, _ = mk.mlap_loss_and_grads(params, eps, None, x, y, mask, hp, **kw)
    parts, loss_parts = {k: [] for k in mk.Q_KEYS}, 0.0
    for r in range(c):
        g = slice(fk.task_lo(r, t, c), fk.task_lo(r + 1, t, c))
        if g.stop == g.start:
            continue
        sub = {**params, "q_means": params["q_means"][g], "q_trils": params["q_trils"][g]}
        part_loss, part, _ = mk.mlap_loss_and_grads(sub, eps, None, x[g], y[g], mask[g], hp, **kw)
        loss_parts = loss_parts + part_loss
        for k in mk.Q_KEYS:
            parts[k].append(part[k])
    for k in mk.Q_KEYS:
        got = torch.cat(parts[k])
        assert float(whole[k].abs().max()) > 1e-3
        assert float((got - whole[k]).abs().max()) <= 1e-12 * float(whole[k].abs().max())
    assert abs(float(loss_parts) - float(loss)) <= 1e-12 * abs(float(loss))


@pytest.mark.parametrize("tile", [1, 2, 3])
def test_tiled_score_is_the_whole_score(tile, monkeypatch):
    """float64: the sample scores of the plain version with the cotangents of
    each tile of tasks alone (a CTA's group of C = 2 over 7 ragged tasks
    walked in tiles, the tiles' partials added in order, then the groups in
    rank order) equal the whole scores within 1e-12: the tiled kernel's
    second pass, each tile's forward again and its own rows' backward."""
    t, n, d, hidden, s, c = 7, 5, 1, (8, 8), 3, 2
    rs = np.random.RandomState(80 + tile)
    x, y, mask, params, hp = _problem(rs, t, n, d, hidden)
    eps = torch.from_numpy(rs.randn(s, hp.dim))
    counts = torch.tensor([1.0, 2.0, 0.0, 1.0, 1.0, 0.0, 2.0], dtype=torch.float64)
    grad = torch.autograd.grad
    seen = {}

    def tiled_grad(outputs, inputs, grad_outputs, **kw):
        whole = grad(outputs, inputs, grad_outputs, retain_graph=True)
        split = torch.zeros_like(whole[0])
        for r in range(c):
            t0, t1 = fk.task_lo(r, t, c), fk.task_lo(r + 1, t, c)
            group = torch.zeros_like(whole[0])
            for j0 in range(t0, t1, tile):
                g = torch.zeros(t, dtype=torch.float64)
                g[j0:min(j0 + tile, t1)] = 1.0
                cot = [v * g.view(1, t, *([1] * (v.dim() - 2))) for v in grad_outputs]
                group = group + grad(outputs, inputs, cot, retain_graph=True)[0]
            split = split + group
        seen["whole"], seen["split"] = whole[0], split
        return whole

    monkeypatch.setattr(torch.autograd, "grad", tiled_grad)
    mk.mlap_loss_and_grads(params, eps, counts, x, y, mask, hp, task_kl_weight=1.0,
                           meta_kl_weight=1e-3, delta=0.1)
    whole, split = seen["whole"], seen["split"]
    assert whole.shape == (s, hp.dim) and float(whole.abs().max()) > 1e-3
    assert float((split - whole).abs().max()) <= 1e-12 * float(whole.abs().max())
