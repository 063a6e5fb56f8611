"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device: a CUDA
kernel has no CPU mode. The file imports no JAX, so it also runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py -q -o addopts="" -m gpu

Errors are compared per system, relative to that system's largest |plain|
value, at rtol 1e-4 (float32 sums in another order; 1e-6 measured). The
fused training kernels are compared after ten to thirty steps, as
chip_smoke.py does.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from meta_learning_pacoh_torch import (
    GPRegressionMetaLearned,
    GPRegressionMetaLearnedSVGD,
    GPRegressionMetaLearnedVI,
)
from meta_learning_pacoh_torch.datasets import CauchyDataset, SinusoidDataset
from meta_learning_pacoh_torch.models.gp_base import init_gp_params
from meta_learning_pacoh_torch.models.random_gp import layout_slice, ravel_flat
from meta_learning_pacoh_torch.ops import cuda, launch_sched
from meta_learning_pacoh_torch.ops.cuda import blocked_mll_kernel as bk
from meta_learning_pacoh_torch.ops.cuda import chol_kernel, chol_small_kernel, mll_kernel, svgd_kernel
from meta_learning_pacoh_torch.ops.cuda import fused_mlap_kernel as lk
from meta_learning_pacoh_torch.ops.cuda import fused_svgd_bign_kernel as sb
from meta_learning_pacoh_torch.ops.cuda import fused_vi_bign_kernel as vb
from meta_learning_pacoh_torch.ops.cuda import fused_map_bign_kernel as bg
from meta_learning_pacoh_torch.ops.cuda import fused_map_kernel as mk
from meta_learning_pacoh_torch.ops.cuda import fused_svgd_kernel as fk
from meta_learning_pacoh_torch.ops.cuda import fused_vi_kernel as vk

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def assert_close_per_system(got, want, rtol=1e-4):
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape
    diff = (got - want).abs().reshape(got.shape[0], -1).amax(1)
    scale = want.abs().reshape(want.shape[0], -1).amax(1)
    assert bool(torch.all(diff <= rtol * scale)), float((diff / scale).max())


def _psd(b, n, seed, scale=0.5):
    rs = np.random.RandomState(seed)
    a = rs.randn(b, n, n + 3)
    return torch.tensor(a @ a.transpose(0, 2, 1) / n + scale * np.eye(n), dtype=torch.float32)


def _escalating(n, lam_min, rs):
    q, _ = np.linalg.qr(rs.randn(n, n))
    lam = rs.uniform(1e-4, 1e-3, n)
    lam[0] = lam_min
    return torch.tensor((q * lam) @ q.T, dtype=torch.float32)


@pytest.mark.parametrize("k,p", [(4, 2372), (10, 2372), (32, 2372), (1, 2372), (2, 2372),
                                 (10, 37), (10, 2371), (1, 37), (2, 2371), (32, 20000)])
def test_svgd_kernel(dev, k, p):
    """K1 over its cluster plan: K from 1 to 32, P of the slice, ragged,
    smaller than one CTA's slice, and too wide for the slices to be staged
    in shared memory. At K=1 the plain version takes the distances as the
    kernel forms them (phi_exact_distances)."""
    gen = torch.Generator().manual_seed(k)
    x = torch.randn(k, p, generator=gen).to(dev)
    s = torch.randn(k, p, generator=gen).to(dev)
    plain = phi_exact_distances if k == 1 else svgd_kernel.svgd_phi_ref
    assert_close_per_system(svgd_kernel.svgd_phi_fused(x, s)[None], plain(x, s)[None])


@pytest.mark.parametrize("cluster", [None, 1, 2, 16])
def test_svgd_kernel_two_calls_same_bits(dev, cluster):
    """The cluster's Gram is summed in rank order, with no float atomics: two
    calls give the same bits, at the plan's and at other cluster sizes."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(10, 2372, generator=gen).to(dev)
    s = torch.randn(10, 2372, generator=gen).to(dev)
    first = svgd_kernel.svgd_phi_fused(x, s, cluster=cluster)
    assert torch.equal(first, svgd_kernel.svgd_phi_fused(x, s, cluster=cluster))
    assert_close_per_system(first[None], svgd_kernel.svgd_phi_ref(x, s)[None])


@pytest.mark.parametrize("n_sys", [1, 4, 5, 7])
def test_svgd_kernel_seed_axis(dev, n_sys):
    """K1 on [S, K, P] (stacked fits: one launch of S clusters, each system
    with its own median) against its batched plain version; S=1 gives the
    bits of the [K, P] call; one launch counted a call, whatever S."""
    gen = torch.Generator().manual_seed(n_sys)
    x = torch.randn(n_sys, 10, 2372, generator=gen).to(dev)
    s = (10.0 * torch.randn(n_sys, 10, 2372, generator=gen)).to(dev)
    x[-1] *= 3.0  # systems of other scales: each its own median
    cuda.reset_launch_counts()
    got = svgd_kernel.svgd_phi_fused(x, s)
    assert cuda.LAUNCHES["svgd_phi"] == 1
    assert_close_per_system(got, svgd_kernel.svgd_phi_ref(x, s))
    for i in range(n_sys):
        single = svgd_kernel.svgd_phi_fused(x[i].contiguous(), s[i].contiguous())
        if n_sys == 1:
            assert torch.equal(got[0], single)
        assert_close_per_system(got[i][None], single[None])


def test_stacked_svgd_step_matches_single_steps(dev, monkeypatch):
    """One stacked general step of three SVGD fits (K1 at [3, 4, P], K2/K3
    at 3 x 4 x 4 systems of N=12) against each fit's own general step from
    the same state, after three warm-up steps (non-zero Adam moments):
    particles within 1e-5, the kernel net's output bias left out."""
    from meta_learning_pacoh_torch.parallel import fit_models_parallel

    monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")
    env = CauchyDataset(random_state=np.random.RandomState(5))
    train = env.generate_meta_train_data(n_tasks=4, n_samples=12)
    kw = dict(num_particles=4, mean_nn_layers=(8, 8), kernel_nn_layers=(8, 8), device=dev)
    singles = [GPRegressionMetaLearnedSVGD(train, random_seed=s, **kw) for s in (1, 2, 3)]
    for m in singles:
        m.meta_fit(n_iter=3, verbose=False)
    stacked = [GPRegressionMetaLearnedSVGD(train, random_seed=s, **kw) for s in (1, 2, 3)]
    for m, single in zip(stacked, singles):
        m.load_state_dict(single.state_dict())
    cuda.reset_launch_counts()
    fit_models_parallel(stacked, n_iter=1, prefer="vmap")
    assert cuda.LAUNCHES["svgd_phi"] == 1 and cuda.LAUNCHES["mll_fwd"] == 1, cuda.LAUNCHES
    for m in singles:
        m.meta_fit(n_iter=1, verbose=False)
    keep = torch.ones(singles[0].hyper_prior.dim, dtype=torch.bool, device=dev)
    keep[singles[0].hyper_prior.slice_of(("kernel_nn", "b_out"))] = False
    for m, single in zip(stacked, singles):
        assert m._step_count == single._step_count == 4
        assert float((m.particles - single.particles)[:, keep].abs().max()) <= 1e-5


@pytest.mark.parametrize("b", [1, 7, 12, 200])
@pytest.mark.parametrize("n", [9, 20, 32, 33, 48, 64])
def test_mll_kernels_with_escalation(dev, n, b):
    """K2 (one warp a system, both register instances) and K3 against their
    plain versions; where the batch has them, system 2 escalates to 1e-4 and
    system 5 to 1e-2. Then the autograd Function's values and gradients."""
    rs = np.random.RandomState(n)
    kn = _psd(b, n, seed=n)
    if b > 5:
        kn[2] = _escalating(n, -5e-5, rs)
        kn[5] = _escalating(n, -5e-3, rs)
    kn, r = kn.to(dev), torch.tensor(rs.randn(b, n), dtype=torch.float32, device=dev)
    for got, want in zip(mll_kernel.mll_fwd(kn, r), mll_kernel.mll_fwd_ref(kn, r)):
        assert_close_per_system(got.reshape(b, -1), want.reshape(b, -1))
    _, _, L, z = mll_kernel.mll_fwd_ref(kn, r)
    gq = torch.tensor(rs.randn(b), dtype=torch.float32, device=dev)
    gl = torch.tensor(rs.randn(b), dtype=torch.float32, device=dev)
    for got, want in zip(mll_kernel.mll_bwd(L, z, gq, gl), mll_kernel.mll_bwd_ref(L, z, gq, gl)):
        assert_close_per_system(got, want)

    # the autograd Function: value and gradients through K2/K3 and through the plain versions
    grads = []
    for fn in (mll_kernel.mll_quad_logdet, mll_kernel.mll_quad_logdet_ref):
        kn_g, r_g = kn.clone().requires_grad_(True), r.clone().requires_grad_(True)
        quad, logdet = fn(kn_g, r_g)
        torch.sum(gq * quad + gl * logdet).backward()
        grads.append((quad.detach(), logdet.detach(), kn_g.grad, r_g.grad))
    for got, want in zip(*grads):
        assert_close_per_system(got.reshape(b, -1), want.reshape(b, -1))


@pytest.mark.parametrize("n", [20, 33, 48])
def test_mll_fwd_system_failing_every_level(dev, n):
    """A system indefinite at every jitter level: K2's quad and logdet are
    non-finite where the plain version's are, its six neighbours agree with
    the plain version."""
    rs = np.random.RandomState(n)
    kn = _psd(7, n, seed=n)
    kn[3] -= 10.0 * torch.eye(n)
    kn, r = kn.to(dev), torch.tensor(rs.randn(7, n), dtype=torch.float32, device=dev)
    got, want = mll_kernel.mll_fwd(kn, r), mll_kernel.mll_fwd_ref(kn, r)
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(torch.isfinite(g), torch.isfinite(w))
        assert not bool(torch.isfinite(g[3]))
    keep = torch.tensor([0, 1, 2, 4, 5, 6], device=dev)
    for g, w in zip(got, want):
        assert_close_per_system(g[keep].reshape(6, -1), w[keep].reshape(6, -1))


@pytest.mark.parametrize("n", [20, 48])
def test_mll_fwd_denormal_pivots_escalate(dev, n):
    """A system scaled into float32's denormals: K2 takes its pivots below
    2^-126 as failed, as the JAX kernel does, and escalates to the 1e-4
    jitter, so its values are finite and agree with the plain version of
    Kn + 1e-4 I; the other systems agree with the plain version."""
    rs = np.random.RandomState(n)
    kn = _psd(4, n, seed=n)
    kn[1] = kn[1] * 1e-39
    kn, r = kn.to(dev), torch.tensor(rs.randn(4, n), dtype=torch.float32, device=dev)
    got = mll_kernel.mll_fwd(kn, r)
    for g in got:
        assert bool(torch.isfinite(g).all())
    lifted = kn + 1e-4 * torch.eye(n, device=dev) * (torch.arange(4, device=dev) == 1)[:, None, None]
    for g, w in zip(got, mll_kernel.mll_fwd_ref(lifted, r)):
        assert_close_per_system(g.reshape(4, -1), w.reshape(4, -1))


@pytest.mark.parametrize("n, b", [(20, 200), (48, 50), (48, 200)])
def test_mll_bwd_on_both_factors(dev, n, b):
    """K3 (one warp a system) on the plain version's L and z and on K2's
    own, with escalating systems, against its plain version; its dKn exactly
    symmetric (both halves sum the same products in the same order)."""
    rs = np.random.RandomState(n + b)
    kn = _psd(b, n, seed=n + b)
    kn[2] = _escalating(n, -5e-5, rs)
    kn[5] = _escalating(n, -5e-3, rs)
    kn, r = kn.to(dev), torch.tensor(rs.randn(b, n), dtype=torch.float32, device=dev)
    gq = torch.tensor(rs.randn(b), dtype=torch.float32, device=dev)
    gl = torch.tensor(rs.randn(b), dtype=torch.float32, device=dev)
    for fwd in (mll_kernel.mll_fwd_ref, mll_kernel.mll_fwd):
        _, _, L, z = fwd(kn, r)
        got = mll_kernel.mll_bwd(L, z, gq, gl)
        for g, w in zip(got, mll_kernel.mll_bwd_ref(L, z, gq, gl)):
            assert_close_per_system(g, w)
        assert torch.equal(got[0], got[0].mT)


@pytest.mark.parametrize("n", [49, 200, 231, 232, 235, 236, 300, 306, 307, 308, 512])
def test_blocked_mll_kernels_with_escalation(dev, n):
    """B4 forward and backward against their plain versions: the forward's
    system in shared memory up to N=307, the backward's up to 306, above in
    device memory; system 2 escalates to 1e-4 and system 4 to 1e-2. Then the
    autograd Function's values and gradients."""
    rs = np.random.RandomState(n)
    kn = _psd(6, n, seed=n)
    kn[2] = _escalating(n, -5e-5, rs)
    kn[4] = _escalating(n, -5e-3, rs)
    kn, r = kn.to(dev), torch.tensor(rs.randn(6, n), dtype=torch.float32, device=dev)
    assert bk.blocked_in_shared(n) == (n <= 307)
    assert bk.blocked_bwd_in_shared(n) == (n <= 306)
    cuda.reset_launch_counts()
    for got, want in zip(bk.blocked_mll_fwd(kn, r), bk.blocked_mll_fwd_ref(kn, r)):
        assert_close_per_system(got.reshape(6, -1), want.reshape(6, -1))
    _, _, L, z = bk.blocked_mll_fwd_ref(kn, r)
    gq = torch.tensor(rs.randn(6), dtype=torch.float32, device=dev)
    gl = torch.tensor(rs.randn(6), dtype=torch.float32, device=dev)
    for got, want in zip(bk.blocked_mll_bwd(L, z, gq, gl), bk.blocked_mll_bwd_ref(L, z, gq, gl)):
        assert_close_per_system(got, want)
    assert cuda.LAUNCHES["blocked_fwd"] == cuda.LAUNCHES["blocked_bwd"] == 1
    grads = []
    for fn in (bk.blocked_mll_quad_logdet, bk.blocked_mll_quad_logdet_ref):
        kn_g, r_g = kn.clone().requires_grad_(True), r.clone().requires_grad_(True)
        quad, logdet = fn(kn_g, r_g)
        torch.sum(gq * quad + gl * logdet).backward()
        grads.append((quad.detach(), logdet.detach(), kn_g.grad, r_g.grad))
    for got, want in zip(*grads):
        assert_close_per_system(got.reshape(6, -1), want.reshape(6, -1))


@pytest.mark.parametrize("n", [200, 306, 307, 512])
def test_blocked_bwd_is_symmetric_and_keeps_nan(dev, n):
    """The B4 backward on the forward kernel's L and z, system 1 failing at
    every jitter level: its dKn and dr come back all NaN, the others' dKn is
    exactly symmetric and within rtol 1e-4 of the plain version; two blocks
    an SM at N=200 (one wave at bench.py's B=200), one above N=206."""
    rs = np.random.RandomState(n + 1)
    kn = _psd(4, n, seed=n + 1)
    kn[1] -= 10.0 * torch.eye(n)
    kn, r = kn.to(dev), torch.tensor(rs.randn(4, n), dtype=torch.float32, device=dev)
    _, _, L, z = bk.blocked_mll_fwd(kn, r)
    gq = torch.tensor(rs.randn(4), dtype=torch.float32, device=dev)
    gl = torch.tensor(rs.randn(4), dtype=torch.float32, device=dev)
    dkn, dr = bk.blocked_mll_bwd(L, z, gq, gl)
    assert bool(torch.isnan(dkn[1]).all()) and bool(torch.isnan(dr[1]).all())
    keep = torch.tensor([0, 2, 3], device=dev)
    assert not bool(torch.isnan(dkn[keep]).any()) and torch.equal(dkn[keep], dkn[keep].mT)
    want = bk.blocked_mll_bwd_ref(L[keep], z[keep], gq[keep], gl[keep])
    for got, w in zip((dkn[keep], dr[keep]), want):
        assert_close_per_system(got, w)
    assert bk.blocked_bwd_blocks_per_sm(n) == (2 if n <= 206 else 1)


@pytest.mark.parametrize("n", [70, 200, 300, 308, 309, 512])
def test_cholesky_kernel(dev, n):
    """N=309 and 512 factor in device memory instead of shared memory; the
    indefinite matrix 1 comes back all NaN in both."""
    assert chol_kernel.chol_in_shared(n) == (n <= 308)
    a = _psd(4, n, seed=n).to(dev)
    a[1] -= 10.0 * torch.eye(n, device=dev)
    got, want = chol_kernel.cholesky_fused(a), chol_kernel.cholesky_ref(a)
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and bool(torch.isnan(got[1]).all())
    keep = [0, 2, 3]
    assert_close_per_system(got[keep], want[keep])


# the tiled kernels' edges: 32-column tiles, and the shared-memory edges of
# the forward (N=307) and of K4 (N=308)
TILED_NS = [65, 95, 96, 97, 127, 128, 129, 200, 306, 307, 308, 309, 512]


@pytest.mark.parametrize("b", [1, 5, 200])
@pytest.mark.parametrize("n", TILED_NS)
def test_tiled_kernels_at_tile_and_footprint_edges(dev, n, b):
    """K4 and the B4 forward against their plain versions on either side of
    a tile's edge and of the packed triangle's shared-memory edge."""
    rs = np.random.RandomState(1000 * b + n)
    kn = _psd(b, n, seed=n + b).to(dev)
    r = torch.tensor(rs.randn(b, n), dtype=torch.float32, device=dev)
    assert_close_per_system(chol_kernel.cholesky_fused(kn), chol_kernel.cholesky_ref(kn))
    for got, want in zip(bk.blocked_mll_fwd(kn, r), bk.blocked_mll_fwd_ref(kn, r)):
        assert_close_per_system(got.reshape(b, -1), want.reshape(b, -1))


def _failing_at(n, p, pivot, rs):
    """An SPD matrix but for pivot p, which is `pivot` exactly: row and
    column p of its factor are zero off the diagonal, so the pivot is the
    diagonal entry plus the jitter (no cancellation, whose rounding 1 / pivot
    would amplify in quad) and the later pivots stay healthy."""
    L = np.eye(n) + 0.3 * np.tril(rs.randn(n, n), -1) / np.sqrt(n)
    L[p + 1:, p] = 0.0
    L[p, :p] = 0.0
    a = L @ L.T
    a[p, p] += pivot - 1.0
    return torch.tensor(a, dtype=torch.float32)


@pytest.mark.parametrize("n", [97, 200])
def test_tiled_escalation_at_tile_columns(dev, n):
    """Systems whose factorization fails at the first, a middle and the last
    column of the second tile: the B4 forward picks the plain version's
    jitter level for each (1e-4 or 1e-2), a system failing every level is
    NaN, and K4 (no jitter) returns all NaN for exactly the failing ones."""
    rs = np.random.RandomState(n)
    cases = [(p, piv) for piv in (-5e-5, -5e-3) for p in (32, 47, 63)] + [(n - 1, -1.0)]
    kn = torch.stack([_psd(1, n, seed=n)[0]] + [_failing_at(n, p, piv, rs) for p, piv in cases])
    kn = kn.to(dev)
    b = kn.shape[0]
    r = torch.tensor(rs.randn(b, n), dtype=torch.float32, device=dev)
    eye = torch.eye(n, device=dev)
    ok = [chol_kernel.diag_ok(chol_kernel.cholesky_ref(kn + j * eye)) for j in (0.0, 1e-4, 1e-2)]
    level = torch.where(ok[0], 0, torch.where(ok[1], 1, torch.where(ok[2], 2, 3)))
    assert level.tolist() == [0, 1, 1, 1, 2, 2, 2, 3]
    quad, logdet, L, z = bk.blocked_mll_fwd(kn, r)
    want = bk.blocked_mll_fwd_ref(kn, r)
    for got, w in zip((quad, logdet, L, z), want):
        assert torch.equal(torch.isnan(got), torch.isnan(w))
        keep = level < 3
        assert_close_per_system(got[keep].reshape(int(keep.sum()), -1),
                                w[keep].reshape(int(keep.sum()), -1))
    # the jitter the kernel used: the mean of diag(L L^T - Kn)
    fit = (L @ L.mT - kn).diagonal(dim1=-2, dim2=-1).mean(-1)
    got_level = torch.argmin((fit[:, None] - torch.tensor([0.0, 1e-4, 1e-2], device=dev)).abs(), 1)
    assert got_level[:7].tolist() == level[:7].tolist()
    assert bool(torch.isnan(L[7]).all()) and bool(torch.isnan(z[7]).all())
    got = chol_kernel.cholesky_fused(kn)
    assert torch.equal(torch.isnan(got), torch.isnan(chol_kernel.cholesky_ref(kn)))
    assert [bool(torch.isnan(g).all()) for g in got] == [False] + [True] * 7
    assert not bool(torch.isnan(got[0]).any())


def test_tiled_kernels_two_blocks_per_sm(dev):
    """At N=200 two blocks of each tiled kernel are resident on an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    assert chol_kernel.chol_blocks_per_sm(200) >= 2
    assert bk.blocked_fwd_blocks_per_sm(200) >= 2


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.randn(10, 64, device=dev)
    with pytest.raises(ValueError):
        svgd_kernel.svgd_phi_fused(x.double(), x.double())
    with pytest.raises(ValueError):
        svgd_kernel.svgd_phi_fused(torch.randn(33, 64, device=dev), torch.randn(33, 64, device=dev))
    with pytest.raises(ValueError):
        chol_kernel.cholesky_fused(torch.randn(2, 80, 80, device=dev).mT)
    with pytest.raises(ValueError):
        mll_kernel.mll_fwd(torch.randn(2, 65, 65, device=dev), torch.randn(2, 65, device=dev))
    with pytest.raises(ValueError):
        bk.blocked_mll_fwd(torch.randn(2, 513, 513, device=dev), torch.randn(2, 513, device=dev))


def test_learner_on_card_matches_plain_cpu_learner(dev, monkeypatch):
    """Five general steps (PACOH_TORCH_DISABLE_FUSED=1: N=12 lies in B10's
    window) and an eval on the card (K1-K4) against the same learner on the
    CPU (plain versions): particles within 1e-4 (the kernel net's output
    bias left out), metrics rtol 1e-3."""
    monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")
    env = CauchyDataset(random_state=np.random.RandomState(5))
    train = env.generate_meta_train_data(n_tasks=4, n_samples=12)
    test = env.generate_meta_test_data(n_tasks=3, n_samples_context=12, n_samples_test=70)
    kw = dict(num_particles=4, mean_nn_layers=(8, 8), kernel_nn_layers=(8, 8), random_seed=30)
    on_card = GPRegressionMetaLearnedSVGD(train, device=dev, **kw)
    on_cpu = GPRegressionMetaLearnedSVGD(train, device="cpu", **kw)
    cuda.reset_launch_counts()
    for model in (on_card, on_cpu):
        model.meta_fit(n_iter=5, verbose=False)
    metrics_card, metrics_cpu = on_card.eval_datasets(test), on_cpu.eval_datasets(test)
    general = ("svgd_phi", "mll_fwd", "mll_bwd", "chol")  # N=12: the general step
    assert all(cuda.LAUNCHES[k] > 0 for k in general), cuda.LAUNCHES
    assert cuda.LAUNCHES["fused_svgd"] == 0, cuda.LAUNCHES
    keep = torch.ones(on_cpu.hyper_prior.dim, dtype=torch.bool)
    keep[on_cpu.hyper_prior.slice_of(("kernel_nn", "b_out"))] = False
    diff = (on_card.particles.cpu() - on_cpu.particles)[:, keep].abs().max()
    assert float(diff) <= 1e-4
    np.testing.assert_allclose(metrics_card, metrics_cpu, rtol=1e-3, atol=1e-5)


def _fused_case(k, t, n, hidden, seed, ragged, dev, d=1):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-2.0, 2.0, (t, n, d)).astype(np.float32)
    y = (np.sin(2.0 * x.sum(-1)) + 0.1 * rs.randn(t, n)).astype(np.float32)
    mask = np.ones((t, n), np.float32)
    if ragged:  # padded points as the learner pads them: zero input and target
        mask[1, n - 2:] = 0.0
        x[1, n - 2:], y[1, n - 2:] = 0.0, 0.0
    hp = fk.fused_prior(d, hidden, 0.5, 3.0)
    theta = hp.loc + hp.scale * torch.from_numpy(rs.randn(k, hp.dim).astype(np.float32))
    data = [torch.from_numpy(a).to(dev) for a in (x, y, mask)]
    return data, theta.to(dev), hp, rs


FUSED_CASES = {  # name -> (K, T, N, hidden, ragged, task batch or None)
    "small_ragged": (4, 4, 5, (8, 8), True, None),
    "sin_20": (10, 20, 5, (32, 32), False, None),
    "sin_20_counted": (10, 20, 5, (32, 32), False, 5),
    "n8_k32_kh1024": (32, 6, 8, (32, 32), True, None),
    "three_layers_n3": (8, 5, 3, (16, 16, 16), False, None),
    "k1": (1, 20, 5, (32, 32), False, None),
    "odd_width_h7": (3, 7, 7, (7, 7), True, None),  # P % 4 == 2: the staging by scalar loads
}


def plan_sizes(k, t):
    """The cluster sizes the kernels' plan can return at K (or S) and T:
    those of CLUSTER_SIZES with no more CTAs than tasks whose K clusters the
    mirror holds at once."""
    return [c for c in fk.CLUSTER_SIZES if c <= t and k <= fk.RESIDENT_CLUSTERS[c]]


def phi_exact_distances(x, s):
    """svgd_phi_ref on squared distances summed from differences, as the
    kernel forms them. At K=1 the expansion |a|^2 + |b|^2 - 2ab leaves
    rounding noise on the diagonal, and that noise is the median that sets
    the bandwidth; the kernel's diagonal is exactly 0 (phi = score)."""
    k = x.shape[0]
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    gamma = 1.0 / (1e-8 + 2.0 * svgd_kernel.median_upper(d2) / (2.0 * math.log(k + 1)))
    k_xx = torch.exp(-gamma * d2)
    return (k_xx @ s + 2.0 * gamma * (x * k_xx.sum(1, keepdim=True) - k_xx @ x)) / k


@pytest.mark.parametrize("case,cluster", [(case, c) for case in sorted(FUSED_CASES)
                                          for c in plan_sizes(*FUSED_CASES[case][:2])])
def test_fused_svgd_kernel_matches_plain(dev, case, cluster, monkeypatch):
    """Ten steps of the fused kernel, at each cluster size its plan can
    return, against its plain version from one state (step0 3, non-zero
    Adam moments): particles within 1e-4 (the kernel net's output bias left
    out), Adam moments within 1e-4 of their largest |plain| value. Two
    launches of 4 + 6 steps give the bits of one launch. At K=1 the plain
    version's transport takes the distances as the kernel forms them
    (phi_exact_distances)."""
    k, t, n, hidden, ragged, batch = FUSED_CASES[case]
    if k == 1:
        monkeypatch.setattr(fk, "svgd_phi_ref", phi_exact_distances)
    (x, y, mask), theta, hp, rs = _fused_case(k, t, n, hidden, sum(map(ord, case)), ragged, dev)
    mu = torch.from_numpy((0.01 * rs.randn(k, hp.dim)).astype(np.float32)).to(dev)
    nu = torch.from_numpy((1e-4 * rs.rand(k, hp.dim)).astype(np.float32)).to(dev)
    counts = None
    if batch is not None:
        counts = np.stack([np.bincount(rs.randint(0, t, batch), minlength=t) for _ in range(10)])
        counts = torch.from_numpy(counts.astype(np.float32)).to(dev)
    w_t = torch.from_numpy(fk.task_weights(mask.cpu().numpy(), batch)).to(dev)
    kw = dict(hidden=hidden, wps=0.5, bps=3.0)

    got, want, split = ([a.clone() for a in (theta, mu, nu)] for _ in range(3))
    cuda.reset_launch_counts()
    fk.fused_svgd_train(*got, x, y, mask, w_t, 3, 1e-3, 0.01, counts, n_steps=10,
                        cluster=cluster, **kw)
    assert cuda.LAUNCHES["fused_svgd"] == 1
    fk.fused_svgd_train_ref(*want, x, y, mask, w_t, 3, 1e-3, 0.01, counts, n_steps=10, **kw)
    for s0, sub in ((0, 4), (4, 6)):
        fk.fused_svgd_train(*split, x, y, mask, w_t, 3 + s0, 1e-3, 0.01,
                            None if counts is None else counts[s0:s0 + sub].contiguous(),
                            n_steps=sub, cluster=cluster, **kw)
    keep = torch.ones(hp.dim, dtype=torch.bool, device=dev)
    keep[hp.slice_of(("kernel_nn", "b_out"))] = False
    assert float((got[0] - want[0])[:, keep].abs().max()) <= 1e-4
    for g, w in zip(got[1:], want[1:]):
        assert float((g - w)[:, keep].abs().max()) <= 1e-4 * float(w.abs().max())
    assert float((got[0] - theta)[:, keep].abs().max()) > 1e-3  # the steps moved it
    for g, s in zip(got, split):
        assert torch.equal(g, s)


def test_fused_kernels_refuse_clusters_the_card_cannot_hold(dev):
    """32 clusters of 8 CTAs are more than the card holds at once (15 on an
    H100 SXM): the C entries of B2, B7 and B8 refuse the launch
    (cudaErrorCooperativeLaunchTooLarge) and the wrappers raise."""
    (x, y, mask), theta, hp, rs = _fused_case(32, 20, 5, (32, 32), 1, False, dev)
    state = [theta, torch.zeros_like(theta), torch.zeros_like(theta)]
    w_t = torch.from_numpy(fk.task_weights(mask.cpu().numpy())).to(dev)
    kw = dict(hidden=(32, 32), wps=0.5, bps=3.0)
    plan = fk.cluster_plan(32, 20, 5, 1, (32, 32), cluster=8)
    assert fk.resident_clusters(32, 20, 5, 1, (32, 32), plan) < 32
    with pytest.raises(RuntimeError, match="CUDA error 720"):
        fk.fused_svgd_train(*state, x, y, mask, w_t, 0, 1e-3, 0.01, n_steps=2, cluster=8, **kw)
    post = [torch.zeros(hp.dim, device=dev) for _ in range(6)]
    eps = torch.randn(2, 32, hp.dim, device=dev)
    with pytest.raises(RuntimeError, match="CUDA error 720"):
        vk.fused_vi_train(*post, x, y, mask, w_t, eps, 0, 1e-3, 0.01, n_steps=2, cluster=8,
                          mll_const=vk.mll_constant(mask.cpu().numpy()), **kw)
    mlap = {"loc": post[0], "log_scale": post[1], "q_means": torch.zeros(20, 5, device=dev),
            "q_trils": torch.zeros(20, 5, 5, device=dev), "raw_noise": torch.zeros((), device=dev)}
    moments = [{k: torch.zeros_like(v) for k, v in mlap.items()} for _ in range(2)]
    assert lk.resident_clusters(20, 5, 1, (32, 32), lk.cluster_plan(32, 20, 5, 1, (32, 32),
                                                                    cluster=8)) < 32
    with pytest.raises(RuntimeError, match="CUDA error 720"):
        lk.fused_mlap_train(mlap, *moments, x, y, mask, eps, None, 0, 1e-3, 1e-3, hidden=(32, 32),
                            wps=0.5, bps=3.0, task_kl_weight=1.0, meta_kl_weight=1e-3, delta=0.1,
                            n_tasks=20, n_steps=2, cluster=8)


def test_mirror_of_resident_clusters_holds_on_the_card(dev):
    """The card holds at least the clusters the Python mirror reckons with,
    for every size, at the sin_20 plans (and at least K of the plan's)."""
    for c in fk.RESIDENT_CLUSTERS:
        plan = fk.cluster_plan(10, 20, 5, 1, (32, 32), cluster=c)
        assert fk.resident_clusters(10, 20, 5, 1, (32, 32), plan) >= fk.RESIDENT_CLUSTERS[c]
        vplan = vk.cluster_plan(10, 20, 5, 1, (32, 32), cluster=c)
        assert vk.resident_clusters(20, 5, 1, (32, 32), vplan) >= fk.RESIDENT_CLUSTERS[c]
        lplan = lk.cluster_plan(5, 20, 5, 1, (32, 32), cluster=c)
        assert lk.resident_clusters(20, 5, 1, (32, 32), lplan) >= fk.RESIDENT_CLUSTERS[c]
    for k in (1, 10, 32):
        plan = fk.cluster_plan(k, 20, 5, 1, (32, 32))
        assert fk.resident_clusters(k, 20, 5, 1, (32, 32), plan) >= k


def test_fused_learner_on_card_matches_plain_cpu_learner(dev):
    """A sin_20-like learner in the fused window: the fit on the card runs
    through the fused kernel alone and lands within 1e-4 of the same fit on
    the CPU (plain version); two chunkings give the same bits."""
    env = SinusoidDataset(random_state=np.random.RandomState(26))
    train = env.generate_meta_train_data(n_tasks=8, n_samples=5)
    test = env.generate_meta_test_data(n_tasks=3, n_samples_context=5, n_samples_test=20)
    kw = dict(num_particles=6, mean_nn_layers=(16, 16), kernel_nn_layers=(16, 16),
              random_seed=30, lr_decay=0.5)
    on_card = GPRegressionMetaLearnedSVGD(train, device=dev, **kw)
    on_cpu = GPRegressionMetaLearnedSVGD(train, device="cpu", **kw)
    assert on_card._fused_path_ok()
    cuda.reset_launch_counts()
    on_card.meta_fit(n_iter=12, log_period=12, verbose=False)
    assert cuda.LAUNCHES["fused_svgd"] == 1 and sum(cuda.LAUNCHES.values()) == 1, cuda.LAUNCHES
    on_cpu.meta_fit(n_iter=12, log_period=12, verbose=False)
    keep = torch.ones(on_cpu.hyper_prior.dim, dtype=torch.bool)
    keep[on_cpu.hyper_prior.slice_of(("kernel_nn", "b_out"))] = False
    assert float((on_card.particles.cpu() - on_cpu.particles)[:, keep].abs().max()) <= 1e-4
    np.testing.assert_allclose(on_card.eval_datasets(test), on_cpu.eval_datasets(test),
                               rtol=1e-3, atol=1e-5)
    chunked = GPRegressionMetaLearnedSVGD(train, device=dev, **kw)
    chunked.meta_fit(n_iter=12, log_period=5, verbose=False)
    assert torch.equal(chunked.particles, on_card.particles)


# name -> (T, N, D, F, mean_hidden, kernel_hidden, ragged, task batch or None, lr_decay, steps)
MAP_CASES = {
    "demo_full_batch": (20, 5, 1, 2, (32, 32), (32, 32), False, None, 1.0, 20),
    "demo_counted": (20, 5, 1, 2, (32, 32), (32, 32), False, 5, 1.0, 20),
    "demo_staircase": (20, 5, 1, 2, (32, 32), (32, 32), False, None, 0.5, 30),
    "odd_shape": (7, 8, 3, 3, (16, 16, 16), (32, 32), True, None, 1.0, 20),
    "grouped_tasks": (300, 4, 2, 2, (8,), (8, 8), True, 37, 1.0, 10),
    # widths that are no multiple of 4: map_nets.cuh's scalar passes in the cluster
    "odd_width_h7_counted": (20, 5, 1, 2, (7, 7), (7, 7), False, 5, 1.0, 20),
    # more tasks than one cluster's CTAs hold: the first design's cooperative grid
    "grid_t1000": (1000, 8, 1, 2, (32, 32), (32, 32), True, 50, 1.0, 10),
}


def map_case(t, n, d, f, mean_hidden, kernel_hidden, ragged, seed, dev):
    """Numpy-seeded tasks and a torch_linear-initialised state [P] on dev."""
    rs = np.random.RandomState(seed)
    x = rs.uniform(-2.0, 2.0, (t, n, d)).astype(np.float32)
    y = (np.sin(2.0 * x.sum(-1)) + 0.1 * rs.randn(t, n)).astype(np.float32)
    mask = np.ones((t, n), np.float32)
    if ragged:  # padded points as the learner pads them: zero input and target
        mask[1, n - 2:] = 0.0
        mask[t - 1, 1:] = 0.0
        x[mask == 0], y[mask == 0] = 0.0, 0.0
    layout = mk.map_layout(d, f, mean_hidden, kernel_hidden)
    cfg = mk.config_of(layout)
    theta = ravel_flat(layout, init_gp_params(cfg, torch.Generator().manual_seed(seed)))
    mu = torch.from_numpy((0.01 * rs.randn(theta.numel())).astype(np.float32))
    nu = torch.from_numpy((1e-4 * rs.rand(theta.numel())).astype(np.float32))
    data = [torch.from_numpy(a).to(dev) for a in (x, y, mask)]
    return data, [a.to(dev) for a in (theta, mu, nu)], layout


@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_fused_map_kernel_matches_plain(dev, case, monkeypatch):
    """The fused MAP kernel against its plain version from one state (step 3,
    non-zero AdamW moments), over the trainer's launches (a staircase of
    10-step transitions for lr_decay < 1): parameters max 1e-4 and mean 2e-6
    (the kernel net's output bias left out: its true gradient is 0), AdamW
    moments within 1e-4 of their largest |plain| value, loss rtol 1e-5. The
    same steps split into two launches give the same bits."""
    _map_kernel_matches_plain(dev, case, MAP_CASES[case], monkeypatch)


@pytest.mark.parametrize("c", [1, 2, 4, 16])
def test_fused_map_kernel_cluster_sizes(dev, c, monkeypatch):
    """B6 with clusters of 1, 2, 4 and 16 CTAs (16: the non-portable size) at
    the demo's counted batch, held to its plain version as above; the plan
    takes the size it is given and the route is the cluster's."""
    monkeypatch.setattr(mk, "CLUSTER_SIZES", (c,))
    assert mk.map_plan(20, 5, 1, 2, (32, 32), (32, 32)) == (c, True)
    _map_kernel_matches_plain(dev, "demo_counted", MAP_CASES["demo_counted"], monkeypatch)


# big-N (B9): bench.py's map_t5_n200 shapes, and tasks of up to 300 points
# (the matrix in device memory), D=2, F=3
BIGN_CASES = {
    "t5_n200_full_batch": (5, 200, 1, 2, (32, 32), (32, 32), False, None, 1.0, 20),
    "t5_n200_counted": (5, 200, 1, 2, (32, 32), (32, 32), False, 2, 1.0, 20),
    "t5_n200_staircase": (5, 200, 1, 2, (32, 32), (32, 32), False, None, 0.5, 30),
    "odd_shape_n300": (4, 300, 2, 3, (16, 16, 16), (16, 16, 16), True, None, 1.0, 20),
    "n12_grouped_tasks": (200, 12, 1, 2, (8, 8), (8, 8), True, 37, 1.0, 10),
    # widths that are no multiple of 4: map_nets.cuh's scalar passes
    "odd_width_h7": (5, 48, 1, 2, (7, 7), (7, 7), True, None, 1.0, 20),
    # per-layer widths in register tiles, the panel edge N = 33
    "mixed_widths_n33": (3, 33, 2, 3, (12, 20, 4), (8, 16), True, None, 1.0, 20),
    # the largest N: the packed matrix and the activations in device memory
    "n512_device_matrix": (2, 512, 1, 2, (32, 32), (32, 32), True, None, 1.0, 10),
    # N = 300 counted, F = 8: the matrix in device memory, undrawn tasks skipped
    "n300_counted_f8": (6, 300, 1, 8, (16, 16), (16, 16), True, 2, 1.0, 10),
    # nets too wide for shared memory beside the system: the parameters in device memory
    "n512_wide_nets_device_params": (2, 512, 1, 2, (136, 136), (136, 136), True, None, 1.0, 10),
}


@pytest.mark.parametrize("case", sorted(BIGN_CASES))
def test_fused_map_bign_kernel_matches_plain(dev, case, monkeypatch):
    """B9 against its plain version, with the tolerances of B6's test above."""
    _map_kernel_matches_plain(dev, case, BIGN_CASES[case], monkeypatch)


def _map_kernel_matches_plain(dev, case, spec, monkeypatch):
    t, n, d, f, mh, kh, ragged, batch, decay, n_steps = spec
    bign = n > mk.MAX_N
    trainer_cls, ref, counter = ((bg.FusedMAPBigNTrainer, bg.fused_map_bign_train_ref,
                                  "fused_map_bign") if bign
                                 else (mk.FusedMAPTrainer, mk.fused_map_train_ref, "fused_map"))
    monkeypatch.setattr(launch_sched, "LR_TRANSITION_STEPS", 10)
    (x, y, mask), state, layout = map_case(t, n, d, f, mh, kh, ragged, sum(map(ord, case)), dev)

    def draw(step):
        return torch.from_numpy(np.random.RandomState(step).randint(0, t, batch))

    trainer = trainer_cls(x, y, mask, layout=layout, lr=1e-3, weight_decay=0.2,
                          lr_decay=decay, task_batch_size=batch, task_draw=draw)
    got, want, split = ([a.clone() for a in state] for _ in range(3))
    cuda.reset_launch_counts()
    got_loss, _ = trainer.run(*got, n_steps, 3)
    assert cuda.LAUNCHES[counter] == len(list(trainer.launches(3, n_steps)))
    for s0, sub in trainer.launches(3, n_steps):
        counts = trainer.count_pages(s0, sub) if trainer.counted else None
        want_loss, _ = ref(
            *want, x, y, mask, trainer.w_t, s0, launch_sched.staircase_lr(1e-3, decay, s0), 0.2,
            counts, layout=layout, n_steps=sub)
    trainer.run(*split, 4, 3)
    trainer.run(*split, n_steps - 4, 7)
    keep = torch.ones(got[0].numel(), dtype=torch.bool, device=dev)
    keep[layout_slice(layout, ("kernel_nn", "b_out"))] = False
    diff = (got[0] - want[0])[keep].abs()
    assert float(diff.max()) <= 1e-4 and float(diff.mean()) <= 2e-6, (diff.max(), diff.mean())
    for g, w in zip(got[1:], want[1:]):
        assert float((g - w)[keep].abs().max()) <= 1e-4 * float(w.abs().max())
    assert abs(float(got_loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert float((got[0] - state[0])[keep].abs().max()) > 1e-3  # the steps moved it
    for g, s in zip(got, split):
        assert torch.equal(g, s)


def test_map_learner_on_card_matches_plain_cpu_learner(dev):
    """The demo's learner at a small width, counted batch of 5: on the card
    the fit runs through the fused MAP kernel alone and lands within 1e-4
    of the same fit on the CPU (plain version); eval rtol 1e-3; two
    chunkings give the same bits; the learner built without a device lives
    on the card."""
    env = SinusoidDataset(random_state=np.random.RandomState(26))
    train = env.generate_meta_train_data(n_tasks=8, n_samples=5)
    test = env.generate_meta_test_data(n_tasks=3, n_samples_context=5, n_samples_test=20)
    kw = dict(mean_nn_layers=(16, 16), kernel_nn_layers=(16, 16), weight_decay=0.2,
              random_seed=30)
    on_card = GPRegressionMetaLearned(train, **kw)
    assert on_card.device.type == "cuda" and on_card._fused_path_ok()
    cuda.reset_launch_counts()
    on_card.meta_fit(n_iter=12, log_period=12, verbose=False)
    assert cuda.LAUNCHES["fused_map"] == 1 and sum(cuda.LAUNCHES.values()) == 1, cuda.LAUNCHES
    on_cpu = GPRegressionMetaLearned(train, device="cpu", **kw)
    assert on_cpu._fused_path_ok()
    on_cpu.meta_fit(n_iter=12, log_period=12, verbose=False)
    keep = torch.ones(on_cpu.params.numel(), dtype=torch.bool)
    keep[layout_slice(on_cpu.layout, ("kernel_nn", "b_out"))] = False
    assert float((on_card.params.cpu() - on_cpu.params)[keep].abs().max()) <= 1e-4
    np.testing.assert_allclose(on_card.eval_datasets(test), on_cpu.eval_datasets(test),
                               rtol=1e-3, atol=1e-5)
    chunked = GPRegressionMetaLearned(train, **kw)
    chunked.meta_fit(n_iter=12, log_period=5, verbose=False)
    assert torch.equal(chunked.params, on_card.params)


def test_bign_map_learner_on_card_matches_plain_cpu_learner(dev):
    """A MAP learner on 4 tasks of 60 points (one ragged) at a small width,
    built without a device: on the card the fit runs through B9 alone and
    lands within 1e-4 of the same fit on the CPU (B9's plain version); eval
    (through K4) rtol 1e-3; two chunkings give the same bits; the general
    step on the card takes B4."""
    env = SinusoidDataset(random_state=np.random.RandomState(5))
    train = env.generate_meta_train_data(n_tasks=4, n_samples=60)
    train[2] = (train[2][0][:45], train[2][1][:45])
    test = env.generate_meta_test_data(n_tasks=3, n_samples_context=70, n_samples_test=30)
    kw = dict(mean_nn_layers=(16, 16), kernel_nn_layers=(16, 16), weight_decay=0.2,
              task_batch_size=-1, random_seed=30)
    on_card = GPRegressionMetaLearned(train, **kw)
    assert on_card.device.type == "cuda" and on_card._fused_path_ok()
    cuda.reset_launch_counts()
    on_card.meta_fit(n_iter=12, log_period=12, verbose=False)
    assert cuda.LAUNCHES["fused_map_bign"] == 1 and sum(cuda.LAUNCHES.values()) == 1, cuda.LAUNCHES
    on_cpu = GPRegressionMetaLearned(train, device="cpu", **kw)
    on_cpu.meta_fit(n_iter=12, log_period=12, verbose=False)
    keep = torch.ones(on_cpu.params.numel(), dtype=torch.bool)
    keep[layout_slice(on_cpu.layout, ("kernel_nn", "b_out"))] = False
    assert float((on_card.params.cpu() - on_cpu.params)[keep].abs().max()) <= 1e-4
    np.testing.assert_allclose(on_card.eval_datasets(test), on_cpu.eval_datasets(test),
                               rtol=1e-3, atol=1e-5)
    chunked = GPRegressionMetaLearned(train, **kw)
    chunked.meta_fit(n_iter=12, log_period=5, verbose=False)
    assert torch.equal(chunked.params, on_card.params)
    monkeypatch = pytest.MonkeyPatch()
    monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")
    try:
        general = GPRegressionMetaLearned(train, **kw)
        cuda.reset_launch_counts()
        general.meta_fit(n_iter=3, log_period=3, verbose=False)
    finally:
        monkeypatch.undo()
    assert cuda.LAUNCHES["blocked_fwd"] == cuda.LAUNCHES["blocked_bwd"] == 3, cuda.LAUNCHES


# name -> (S, T, N, D, hidden, ragged, task batch or None, lr_decay)
VI_CASES = {
    "sin_20_full_batch": (10, 20, 5, 1, (32, 32), False, None, 1.0),
    "sin_20_counted": (10, 20, 5, 1, (32, 32), False, 5, 1.0),
    "sin_20_staircase": (10, 20, 5, 1, (32, 32), False, None, 0.5),
    "odd_shape": (3, 7, 7, 2, (16, 16, 16), True, None, 1.0),
    "s1": (1, 20, 5, 1, (32, 32), False, None, 1.0),
    "s32": (32, 20, 5, 1, (32, 32), False, None, 1.0),
}


def _numpy_eps(s, p):
    """A noise draw of one global step from a numpy seed: fills out [S, P]."""
    def draw(step, out):
        page = np.random.RandomState(1000 + step).randn(s, p).astype(np.float32)
        out.copy_(torch.from_numpy(page))
    return draw


@pytest.mark.parametrize("case,cluster", [(case, c) for case in sorted(VI_CASES)
                                          for c in plan_sizes(VI_CASES[case][0],
                                                              VI_CASES[case][1])])
def test_fused_vi_kernel_matches_plain(dev, case, cluster, monkeypatch):
    """The fused VI kernel, at each cluster size its plan can return, against
    its plain version from one state (step 3, non-zero Adam moments), 20
    steps over the trainer's launches (a staircase of 10-step transitions
    for lr_decay < 1) with one set of noise pages:
    loc and log_scale max 1e-4 and mean 2e-6 (the kernel net's output bias
    left out: its true gradient is 0), the Adam moments within 1e-4 of their
    largest |plain| value, the last loss rtol 1e-5. The same steps split
    into two launches give the same bits."""
    s, t, n, d, hidden, ragged, batch, decay = VI_CASES[case]
    monkeypatch.setattr(launch_sched, "LR_TRANSITION_STEPS", 10)
    rs = np.random.RandomState(sum(map(ord, case)))
    x = rs.uniform(-2.0, 2.0, (t, n, d)).astype(np.float32)
    y = (np.sin(2.0 * x.sum(-1)) + 0.1 * rs.randn(t, n)).astype(np.float32)
    mask = np.ones((t, n), np.float32)
    if ragged:  # padded points as the learner pads them: zero input and target
        mask[1, n - 2:] = 0.0
        mask[t - 1, 1:] = 0.0
        x[mask == 0], y[mask == 0] = 0.0, 0.0
    hp = fk.fused_prior(d, hidden, 0.5, 3.0)
    p = hp.dim
    state = [0.1 * rs.randn(p), np.log(0.1) + 0.1 * rs.randn(p), 0.01 * rs.randn(p),
             0.01 * rs.randn(p), 1e-4 * rs.rand(p), 1e-4 * rs.rand(p)]
    state = [torch.tensor(a, dtype=torch.float32, device=dev) for a in state]
    x, y, mask = (torch.from_numpy(a).to(dev) for a in (x, y, mask))

    def draw(step):
        return torch.from_numpy(np.random.RandomState(step).randint(0, t, batch))

    trainer = vk.FusedVITrainer(x, y, mask, hidden=hidden, lr=1e-3, prior_factor=0.01,
                                weight_prior_std=0.5, bias_prior_std=3.0, svi_batch_size=s,
                                eps_draw=_numpy_eps(s, p), lr_decay=decay,
                                task_batch_size=batch, task_draw=draw, cluster=cluster)
    got, want, split = ([a.clone() for a in state] for _ in range(3))
    cuda.reset_launch_counts()
    got_loss, _ = trainer.run(*got, 20, 3)
    assert cuda.LAUNCHES["fused_vi"] == len(list(trainer.launches(3, 20)))
    for s0, sub in trainer.launches(3, 20):
        counts = trainer.count_pages(s0, sub) if trainer.counted else None
        want_loss, _ = vk.fused_vi_train_ref(
            *want, x, y, mask, trainer.w_t, trainer.eps_pages(s0, sub), s0,
            launch_sched.staircase_lr(1e-3, decay, s0), 0.01, counts, hidden=hidden, wps=0.5,
            bps=3.0, mll_const=trainer.mll_const, n_steps=sub)
    trainer.run(*split, 4, 3)
    trainer.run(*split, 16, 7)
    keep = torch.ones(p, dtype=torch.bool, device=dev)
    keep[hp.slice_of(("kernel_nn", "b_out"))] = False
    for g, w in zip(got[:2], want[:2]):
        diff = (g - w)[keep].abs()
        assert float(diff.max()) <= 1e-4 and float(diff.mean()) <= 2e-6, (diff.max(), diff.mean())
    for g, w in zip(got[2:], want[2:]):
        assert float((g - w)[keep].abs().max()) <= 1e-4 * float(w.abs().max())
    assert abs(float(got_loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert float((got[0] - state[0])[keep].abs().max()) > 1e-3  # the steps moved it
    for g, sp in zip(got, split):
        assert torch.equal(g, sp)


def test_vi_learner_on_card_matches_plain_cpu_learner(dev):
    """A sin_20-like VI learner in the fused window, both learners fed one set
    of noise pages and of eval samples (the card's and the CPU's generators
    differ): on the card the fit runs through the fused VI kernel alone and
    lands within 1e-4 of the same fit on the CPU (plain version); eval rtol
    1e-3; two chunkings give the same bits; the learner built without a
    device lives on the card."""
    env = SinusoidDataset(random_state=np.random.RandomState(26))
    train = env.generate_meta_train_data(n_tasks=8, n_samples=5)
    test = env.generate_meta_test_data(n_tasks=3, n_samples_context=5, n_samples_test=20)
    kw = dict(svi_batch_size=6, mean_nn_layers=(16, 16), kernel_nn_layers=(16, 16),
              random_seed=30)
    on_card = GPRegressionMetaLearnedVI(train, **kw)
    on_cpu = GPRegressionMetaLearnedVI(train, device="cpu", **kw)
    chunked = GPRegressionMetaLearnedVI(train, **kw)
    p = on_cpu.hyper_prior.dim
    samples = torch.from_numpy(np.random.RandomState(5).randn(100, p).astype(np.float32))
    for model in (on_card, on_cpu, chunked):
        model._draw_eps = _numpy_eps(6, p)
        model._posterior_eps = lambda k, dev_=model.device: samples[:k].to(dev_)
    assert on_card.device.type == "cuda" and on_card._fused_path_ok()
    cuda.reset_launch_counts()
    on_card.meta_fit(n_iter=12, log_period=12, verbose=False)
    assert cuda.LAUNCHES["fused_vi"] == 1 and sum(cuda.LAUNCHES.values()) == 1, cuda.LAUNCHES
    on_cpu.meta_fit(n_iter=12, log_period=12, verbose=False)
    keep = torch.ones(p, dtype=torch.bool)
    keep[on_cpu.hyper_prior.slice_of(("kernel_nn", "b_out"))] = False
    for key in ("loc", "log_scale"):
        diff = (on_card.posterior[key].cpu() - on_cpu.posterior[key])[keep].abs().max()
        assert float(diff) <= 1e-4, (key, float(diff))
    np.testing.assert_allclose(on_card.eval_datasets(test), on_cpu.eval_datasets(test),
                               rtol=1e-3, atol=1e-5)
    chunked.meta_fit(n_iter=12, log_period=5, verbose=False)
    for key in ("loc", "log_scale"):
        assert torch.equal(chunked.posterior[key], on_card.posterior[key])


@pytest.mark.parametrize("b", [1, 20, 200, 257])
@pytest.mark.parametrize("n", [32, 50, 64])
def test_chol_small_kernel(dev, n, b):
    """B5 against its plain version, one launch for the batch."""
    a = _psd(b, n, seed=n + b).to(dev)
    cuda.reset_launch_counts()
    got = chol_small_kernel.cholesky_small(a)
    assert cuda.LAUNCHES["chol_small"] == 1
    assert_close_per_system(got, chol_kernel.cholesky_ref(a))
    assert float(torch.triu(got, 1).abs().max()) == 0.0


def test_chol_small_kernel_fails_one_matrix_to_nan(dev):
    a = _psd(20, 50, seed=3).to(dev)
    lam = torch.linalg.eigvalsh(a[7].double())
    a[7] -= float(lam[0] + 1e-2) * torch.eye(50, device=dev)
    got, want = chol_small_kernel.cholesky_small(a), chol_kernel.cholesky_ref(a)
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and bool(torch.isnan(got[7]).all())
    others = torch.arange(20, device=dev) != 7
    assert_close_per_system(got[others], want[others])


@pytest.mark.parametrize("n", [32, 50, 64])
def test_chol_small_kernel_denormal_pivot(dev, n):
    """A matrix whose pivots 0 and 17 are 1e-39, below float32's smallest
    normal (2^-126), their rows and columns zero elsewhere: B5 takes every
    finite positive pivot, so its NaN pattern is its plain version's on the
    card, and where the plain version factors, so does B5, to its values."""
    a = _psd(4, n, seed=n).to(dev)
    for k in (0, 17):
        a[2, k, :] = 0.0
        a[2, :, k] = 0.0
        a[2, k, k] = 1e-39
    assert 0.0 < float(a[2, 17, 17]) < torch.finfo(torch.float32).tiny
    got, want = chol_small_kernel.cholesky_small(a), chol_kernel.cholesky_ref(a)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    factored = ~torch.isnan(want).reshape(4, -1).any(1)
    assert bool(factored[[0, 1, 3]].all())
    assert_close_per_system(got[factored], want[factored])


# name -> (learner keywords, task batch, meta-test, (T, N, D), task sizes)
MLAP_CASES = {
    "full_batch": (dict(), None, False, (20, 5, 1), None),
    "sampled": (dict(task_batch_size=5), 5, False, (20, 5, 1), None),
    "meta_test": (dict(), None, True, (20, 5, 1), None),
    "odd": (dict(svi_batch_size=3, mean_nn_layers=(16, 16, 16), kernel_nn_layers=(16, 16, 16)),
            7, False, (7, 7, 2), (7, 5, 7, 3, 7, 6, 2)),
    "meta_test_t5": (dict(), None, True, (5, 5, 1), None),
}
MLAP_S = {"odd": 3}  # samples where a case is not the learner's default 5


@pytest.mark.parametrize("case,cluster", [(case, c) for case in sorted(MLAP_CASES)
                                          for c in plan_sizes(MLAP_S.get(case, 5),
                                                              MLAP_CASES[case][3][0])])
def test_fused_mlap_kernel_matches_plain(dev, case, cluster):
    """B8, at each cluster size its plan can return, against its plain
    version on the card, 20 steps in one launch from chip_smoke.py's
    well-conditioned state, with the twins' tolerances
    (chip_smoke.compare_mlap)."""
    kw, batch, meta_test, (t, n, d), sizes = MLAP_CASES[case]
    rs = np.random.RandomState(len(case))
    model = chip_smoke.mlap_model(chip_smoke.conditioned_tasks(rs, t, n, d, sizes), **kw)
    model.load_state_dict(chip_smoke.conditioned_state(model, rs))
    eps = torch.from_numpy(rs.randn(20, model.svi_batch_size, model.hyper_prior.dim).astype(
        np.float32)).to(dev)
    counts = None
    if batch is not None:
        counts = torch.stack([torch.bincount(model._task_draw(i), minlength=t).float()
                              for i in range(20)]).to(dev)
    lrs = (1e-2, 1e-2) if meta_test else (1e-3, 1e-3)
    kw8 = dict(hidden=tuple(model.cfg.mean_nn_layers), wps=0.5, bps=3.0, task_kl_weight=1.0,
               meta_kl_weight=1e-3, delta=0.1, n_tasks=t, meta_test=meta_test, n_steps=20)
    got, want = chip_smoke.mlap_state(model), chip_smoke.mlap_state(model)
    cuda.reset_launch_counts()
    got_loss, _, _ = lk.fused_mlap_train(*got, model.X, model.Y, model.mask, eps, counts, 0, *lrs,
                                         batch=batch, cluster=cluster, **kw8)
    assert cuda.LAUNCHES["fused_mlap"] == 1 and sum(cuda.LAUNCHES.values()) == 1
    want_loss, _, _ = lk.fused_mlap_train_ref(*want, model.X, model.Y, model.mask, eps, counts, 0,
                                              *lrs, **kw8)
    skip = model.hyper_prior.slice_of(("kernel_nn", "b_out"))
    chip_smoke.compare_mlap(case, got, want, got_loss, want_loss, skip, meta_test)


def test_mlap_learner_on_card_matches_plain_cpu_learner(dev, monkeypatch):
    """A learner built without a device (the card) and one on the CPU, from
    one well-conditioned state and fed one set of noise: 12 steps through B8
    alone land within 1e-4 of the CPU's plain version; the eval's meta-test
    runs through B8 and its 40-point predictive covariances through B5, LL,
    RMSE and calibration rtol 1e-3; two chunkings give the same bits."""
    rs = np.random.RandomState(4)
    tasks = chip_smoke.conditioned_tasks(rs, 8, 5)
    test = [(cx, cy, np.linspace(-3.0, 3.0, 40)[:, None], np.sin(np.linspace(-3.0, 3.0, 40)))
            for cx, cy in chip_smoke.conditioned_tasks(rs, 3, 5)]
    kw = dict(svi_batch_size=4, mean_nn_layers=(16, 16), kernel_nn_layers=(16, 16))
    on_card = chip_smoke.mlap_model(tasks, **kw)
    on_cpu = chip_smoke.mlap_model(tasks, device="cpu", **kw)
    chunked = chip_smoke.mlap_model(tasks, **kw)
    state = chip_smoke.conditioned_state(on_cpu, rs)
    p = on_cpu.hyper_prior.dim
    draws = np.random.RandomState(6)
    agg = torch.from_numpy(draws.randn(20, p).astype(np.float32))
    init = torch.from_numpy(draws.randn(3, 5).astype(np.float32))
    steps = torch.from_numpy(draws.randn(20, 4, p).astype(np.float32))
    for model in (on_card, on_cpu, chunked):
        model.load_state_dict(state)
        model._draw_eps = _numpy_eps(4, p)
        dev_ = model.device
        model._agg_eps = lambda seed, dev_=dev_: agg.to(dev_)
        model._meta_test_eps = lambda seed, s0, k, dev_=dev_: steps[s0:s0 + k].to(dev_)
        model._init_task_posteriors = (
            lambda post, X, mask, seed, m=model, dev_=dev_: m._init_q(
                post["loc"] + torch.exp(post["log_scale"]) * agg.to(dev_), init.to(dev_), X, mask))
    assert on_card.device.type == "cuda" and on_card._fused_path_ok()
    cuda.reset_launch_counts()
    on_card.meta_fit(n_iter=12, log_period=12, verbose=False)
    assert cuda.LAUNCHES["fused_mlap"] == 1 and sum(cuda.LAUNCHES.values()) == 1, cuda.LAUNCHES
    on_cpu.meta_fit(n_iter=12, log_period=12, verbose=False)
    keep = torch.ones(p, dtype=torch.bool)
    keep[on_cpu.hyper_prior.slice_of(("kernel_nn", "b_out"))] = False
    for key in ("loc", "log_scale", "q_means", "q_trils", "raw_noise"):
        diff = (on_card.params[key].cpu() - on_cpu.params[key]).reshape(-1)
        if key in ("loc", "log_scale"):
            diff = diff[keep]
        assert float(diff.abs().max()) <= 1e-4, (key, float(diff.abs().max()))
    cuda.reset_launch_counts()
    got = on_card.eval_datasets(test, n_iter_meta_test=20)
    assert cuda.LAUNCHES["fused_mlap"] == 1 and cuda.LAUNCHES["chol_small"] > 0, cuda.LAUNCHES
    np.testing.assert_allclose(got, on_cpu.eval_datasets(test, n_iter_meta_test=20), rtol=1e-3,
                               atol=1e-5)
    chunked.meta_fit(n_iter=12, log_period=5, verbose=False)
    for key in on_card.params:
        assert torch.equal(chunked.params[key], on_card.params[key])


# name -> (K or S, T, N, hidden, ragged, task batch or None, lr_decay)
BIGN_FUSED_CASES = {
    "small_ragged": (4, 3, 12, (8, 8), True, None, 1.0),
    "t5_n200": (10, 5, 200, (32, 32), False, None, 1.0),
    "t5_n200_counted": (10, 5, 200, (32, 32), False, 2, 1.0),
    "t5_n200_staircase": (10, 5, 200, (32, 32), False, None, 0.5),
    # the packed triangle holds N=240 in shared memory since the tiled layout
    "n240_three_layers_packed": (4, 2, 240, (16, 16, 16), True, None, 1.0),
    # G = 156 > 132 systems: B11 groups two a block; B10 takes one a block, two blocks an SM
    "grouped_systems": (6, 26, 20, (16, 16), True, None, 1.0),
    # cauchy_20's shape (D=2, BIGN_DIMS): B10's 200 blocks of 256 threads, two an SM
    "cauchy20_coresident": (10, 20, 20, (32, 32), True, None, 1.0),
    # the 32-column panels' edges and the window's largest N
    "n31_panel_edge": (4, 3, 31, (8, 8), True, None, 1.0),
    "n32_panel_edge": (4, 3, 32, (8, 8), False, None, 1.0),
    "n33_panel_edge": (4, 3, 33, (8, 8), True, None, 1.0),
    "n65_panel_edge": (4, 2, 65, (16, 16), True, None, 1.0),
    "n256_window_edge": (4, 2, 256, (16, 16), True, None, 1.0),
    # wide nets leave no room for the triangle: the matrix in device memory
    "n240_wide_nets_device_matrix": (4, 2, 240, (128, 128), True, None, 1.0),
    # a width that is no multiple of the nets' 4-unit register tiles
    "odd_width_h7": (3, 4, 40, (7, 7), True, None, 1.0),
}
# the plan's placement where a case is about it: 2 the matrix and the
# activations in shared memory, 1 the matrix alone, 0 neither
BIGN_SHARED = {"t5_n200": 2, "n240_three_layers_packed": 1, "n256_window_edge": 1,
               "n240_wide_nets_device_matrix": 0, "cauchy20_coresident": 2}
# B10's block width where a case is about it: 256 two blocks an SM, 512 one
BIGN_THREADS = {"t5_n200": 512, "grouped_systems": 256, "cauchy20_coresident": 256}
BIGN_DIMS = {"cauchy20_coresident": 2}  # the input dimension D, where it is not 1


def _bign_trainer_run(trainer, ref, got, want, split, n_steps, counter, **kw):
    """The trainer's launches from step 3 against the plain version ``ref`` over
    the same launches, in float32 (``want``) and in float64; the same steps
    again as 4 + the rest from ``split``. Returns the last losses (kernel,
    plain) and the float64 run's state."""
    wide = [a.double() for a in want]
    cuda.reset_launch_counts()
    got_loss = trainer.run(*got, n_steps, 3)
    assert cuda.LAUNCHES[counter] == len(list(trainer.launches(3, n_steps)))
    want_loss = None
    for s0, sub in trainer.launches(3, n_steps):
        counts = trainer.count_pages(s0, sub) if trainer.counted else None
        extra = [trainer.eps_pages(s0, sub)] if hasattr(trainer, "eps_pages") else []
        args = (trainer.X, trainer.Y, trainer.mask, trainer.w_t, *extra, s0,
                launch_sched.staircase_lr(1e-3, trainer.lr_decay, s0), 0.01, counts)
        kwargs = dict(hidden=trainer.hidden, wps=0.5, bps=3.0, n_steps=sub, **kw)
        want_loss = ref(*want, *args, **kwargs)
        # w_t stays float32 (the plain version checks it); the rest promotes
        ref(*wide, *[a.double() if torch.is_tensor(a) and a is not trainer.w_t else a
                     for a in args], **kwargs)
    trainer.run(*split, 4, 3)
    trainer.run(*split, n_steps - 4, 7)
    return got_loss, want_loss, wide


@pytest.mark.parametrize("case", sorted(BIGN_FUSED_CASES))
def test_fused_svgd_bign_kernel_matches_plain(dev, case, monkeypatch):
    """B10 against its plain version from one state (step 3, non-zero Adam
    moments), 20 steps over the trainer's launches (a staircase of 10-step
    transitions for lr_decay < 1): particles max 1e-4 and mean 2e-6 (the
    kernel net's output bias left out) and the Adam moments within 1e-4 of
    their largest |value|, both in the plain version's float64 run (not its
    float32 run: clustered inputs and a small noise leave the Gram matrix
    ill-conditioned; small_ragged's float32 plain m lies 3.2e-4 from its
    float64 run, n33_panel_edge's float32 plain particles 5.0e-5 max and
    2.8e-6 mean, where the kernel's are 1.9e-6 and 7.7e-8). The same steps
    split into two launches give the same bits. A plan of two blocks an SM
    counts every launch under fused_svgd_bign_coresident, any other none."""
    k, t, n, hidden, ragged, batch, decay = BIGN_FUSED_CASES[case]
    d = BIGN_DIMS.get(case, 1)
    monkeypatch.setattr(launch_sched, "LR_TRANSITION_STEPS", 10)
    (x, y, mask), theta, hp, rs = _fused_case(k, t, n, hidden, sum(map(ord, case)), ragged, dev,
                                              d)
    mu = torch.from_numpy((0.01 * rs.randn(k, hp.dim)).astype(np.float32)).to(dev)
    nu = torch.from_numpy((1e-4 * rs.rand(k, hp.dim)).astype(np.float32)).to(dev)

    def draw(step):
        return torch.from_numpy(np.random.RandomState(step).randint(0, t, batch))

    plan = sb.svgd_bign_plan(k, t, n, d, hidden)
    if case in BIGN_SHARED:
        assert plan[2] == BIGN_SHARED[case]
    if case in BIGN_THREADS:
        assert plan[3] == BIGN_THREADS[case]
    trainer = sb.FusedSVGDBigNTrainer(x, y, mask, hidden=hidden, lr=1e-3, prior_factor=0.01,
                                      weight_prior_std=0.5, bias_prior_std=3.0, lr_decay=decay,
                                      task_batch_size=batch, task_draw=draw)
    got, want, split = ([a.clone() for a in (theta, mu, nu)] for _ in range(3))
    _, _, wide = _bign_trainer_run(trainer, sb.fused_svgd_bign_train_ref, got, want, split, 20,
                                   "fused_svgd_bign")
    keep = torch.ones(hp.dim, dtype=torch.bool, device=dev)
    keep[hp.slice_of(("kernel_nn", "b_out"))] = False
    diff = (got[0].double() - wide[0])[:, keep].abs()
    assert float(diff.max()) <= 1e-4 and float(diff.mean()) <= 2e-6, (diff.max(), diff.mean())
    for g, w in zip(got[1:], wide[1:]):
        err = float((g.double() - w)[:, keep].abs().max()) / float(w.abs().max())
        assert err <= 1e-4, err
    assert float((got[0] - theta)[:, keep].abs().max()) > 1e-3  # the steps moved it
    for g, sp in zip(got, split):
        assert torch.equal(g, sp)
    coresident = cuda.LAUNCHES["fused_svgd_bign"] if plan[3] < sb.THREADS else 0
    assert cuda.LAUNCHES["fused_svgd_bign_coresident"] == coresident, cuda.LAUNCHES


@pytest.mark.parametrize("case", sorted(BIGN_FUSED_CASES))
def test_fused_vi_bign_kernel_matches_plain(dev, case, monkeypatch):
    """B11 against its plain version from one state (step 3, non-zero Adam
    moments), 20 steps over the trainer's launches with one set of noise
    pages: loc and log_scale max 1e-4 and mean 2e-6, the Adam moments within
    1e-4 of their largest |value| in the plain version's float64 run (as
    B10's test), the last loss rtol 1e-5. The same steps split into two
    launches give the same bits."""
    s, t, n, hidden, ragged, batch, decay = BIGN_FUSED_CASES[case]
    d = BIGN_DIMS.get(case, 1)
    monkeypatch.setattr(launch_sched, "LR_TRANSITION_STEPS", 10)
    (x, y, mask), _, hp, rs = _fused_case(1, t, n, hidden, sum(map(ord, case)), ragged, dev, d)
    p = hp.dim
    state = [0.1 * rs.randn(p), np.log(0.1) + 0.1 * rs.randn(p), 0.01 * rs.randn(p),
             0.01 * rs.randn(p), 1e-4 * rs.rand(p), 1e-4 * rs.rand(p)]
    state = [torch.tensor(a, dtype=torch.float32, device=dev) for a in state]

    def draw(step):
        return torch.from_numpy(np.random.RandomState(step).randint(0, t, batch))

    if case in BIGN_SHARED:
        assert vb.vi_bign_plan(s, t, n, d, hidden)[2] == BIGN_SHARED[case]
    trainer = vb.FusedVIBigNTrainer(x, y, mask, hidden=hidden, lr=1e-3, prior_factor=0.01,
                                    weight_prior_std=0.5, bias_prior_std=3.0, svi_batch_size=s,
                                    eps_draw=_numpy_eps(s, p), lr_decay=decay,
                                    task_batch_size=batch, task_draw=draw)
    got, want, split = ([a.clone() for a in state] for _ in range(3))
    (got_loss, _), (want_loss, _), wide = _bign_trainer_run(
        trainer, vb.fused_vi_bign_train_ref, got, want, split, 20, "fused_vi_bign",
        mll_const=trainer.mll_const)
    keep = torch.ones(p, dtype=torch.bool, device=dev)
    keep[hp.slice_of(("kernel_nn", "b_out"))] = False
    for g, w in zip(got[:2], want[:2]):
        diff = (g - w)[keep].abs()
        assert float(diff.max()) <= 1e-4 and float(diff.mean()) <= 2e-6, (diff.max(), diff.mean())
    for g, w in zip(got[2:], wide[2:]):
        err = float((g.double() - w)[keep].abs().max()) / float(w.abs().max())
        assert err <= 1e-4, err
    assert abs(float(got_loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert float((got[0] - state[0])[keep].abs().max()) > 1e-3  # the steps moved it
    for g, sp in zip(got, split):
        assert torch.equal(g, sp)


def test_fused_map_bign_kernel_escalates(dev):
    """B9 on map_t5_n200's tasks with duplicated inputs, an outputscale of
    1000 and a noise of softplus(-30) (chip_smoke.map_bign_escalation): no
    further from its float64 plain run at the float32 levels than twice the
    float32 plain version (or the twins' limits), and nearer to it than to
    the float64 run at level 0."""
    out = chip_smoke.map_bign_escalation()
    assert out["b9"][1] < out["b9_level0"][1]


def test_fused_bign_kernels_escalate(dev):
    """B10 and B11 on svgd_t5_n200's tasks with duplicated inputs and a noise
    of about 1e-13 (chip_smoke.bign_escalation): their factor fails in
    float32 at level 0 and takes the jitter 1e-4; B10's particles lie no
    further from the float64 plain run at that level than the float32 plain
    version's, and B11's first-step loss within 1e-2 of it, far from the
    level-0 run's."""
    out = chip_smoke.bign_escalation()
    assert out["b10"][0] <= out["b10_plain32"][0]
    assert out["b11_loss_rel"] <= chip_smoke.BIGN_ESC_LOSS_RTOL


def test_bign_learners_on_card_match_plain_cpu_learners(dev):
    """An SVGD and a VI learner of 6 tasks x 12 points, built without a device
    (the card), against the same learners on the CPU (VI fed one set of noise
    pages): 12 steps through B10 (B11) alone land within 1e-4 of the CPU's
    plain version; two chunkings give the same bits."""
    env = SinusoidDataset(random_state=np.random.RandomState(26))
    train = env.generate_meta_train_data(n_tasks=6, n_samples=12)
    kw = dict(mean_nn_layers=(16, 16), kernel_nn_layers=(16, 16), random_seed=30)
    for cls, extra, counter, state_of in (
            (GPRegressionMetaLearnedSVGD, dict(num_particles=6), "fused_svgd_bign",
             lambda m: [m.particles]),
            (GPRegressionMetaLearnedVI, dict(svi_batch_size=6), "fused_vi_bign",
             lambda m: [m.posterior["loc"], m.posterior["log_scale"]])):
        on_card, chunked = cls(train, **kw, **extra), cls(train, **kw, **extra)
        on_cpu = cls(train, device="cpu", **kw, **extra)
        p = on_cpu.hyper_prior.dim
        if cls is GPRegressionMetaLearnedVI:
            for model in (on_card, on_cpu, chunked):
                model._draw_eps = _numpy_eps(6, p)
        assert on_card.device.type == "cuda" and on_card._fused_path_ok()
        cuda.reset_launch_counts()
        on_card.meta_fit(n_iter=12, log_period=12, verbose=False)
        assert cuda.LAUNCHES[counter] == 1 and sum(cuda.LAUNCHES.values()) == 1, cuda.LAUNCHES
        on_cpu.meta_fit(n_iter=12, log_period=12, verbose=False)
        keep = torch.ones(p, dtype=torch.bool)
        keep[on_cpu.hyper_prior.slice_of(("kernel_nn", "b_out"))] = False
        for a, b in zip(state_of(on_card), state_of(on_cpu)):
            assert float((a.cpu() - b)[..., keep].abs().max()) <= 1e-4
        chunked.meta_fit(n_iter=12, log_period=5, verbose=False)
        for a, b in zip(state_of(chunked), state_of(on_card)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n", [20, 200])
def test_mll_kernels_at_one_system(dev, n):
    """One system a launch, as the single-task learners call them: K2/K3 at
    N=20, B4 at N=200, against their plain versions; a system failing at
    every jitter level is non-finite through both directions."""
    fwd, fwd_ref, bwd, bwd_ref = ((mll_kernel.mll_fwd, mll_kernel.mll_fwd_ref,
                                   mll_kernel.mll_bwd, mll_kernel.mll_bwd_ref) if n <= 48 else
                                  (bk.blocked_mll_fwd, bk.blocked_mll_fwd_ref,
                                   bk.blocked_mll_bwd, bk.blocked_mll_bwd_ref))
    kn = _psd(1, n, seed=n).to(dev)
    r = torch.randn(1, n, generator=torch.Generator().manual_seed(n)).to(dev)
    gq, gl = torch.tensor([0.7], device=dev), torch.tensor([-1.3], device=dev)
    for g_, w_ in zip(fwd(kn, r), fwd_ref(kn, r)):
        assert_close_per_system(g_.reshape(1, -1), w_.reshape(1, -1))
    _, _, L, z = fwd_ref(kn, r)
    for g_, w_ in zip(bwd(L, z, gq, gl), bwd_ref(L, z, gq, gl)):
        assert_close_per_system(g_.reshape(1, -1), w_.reshape(1, -1))
    failed = kn - 10.0 * torch.eye(n, device=dev)
    _, _, fL, fz = fwd(failed, r)
    dkn, dr = bwd(fL, fz, gq, gl)
    assert not bool(torch.isfinite(fz).any()) and not bool(torch.isfinite(dkn).any())
    assert not bool(torch.isfinite(dr).any())


def test_cholesky_kernel_at_one_system(dev):
    """K4 at B=1, N=200 (GPR-PAC's KL and the single-task predictives)
    against its plain version; an indefinite matrix comes back all NaN."""
    a = _psd(1, 200, seed=3).to(dev)
    assert_close_per_system(chol_kernel.cholesky_fused(a), chol_kernel.cholesky_ref(a))
    failed = a - 10.0 * torch.eye(200, device=dev)
    assert bool(torch.isnan(chol_kernel.cholesky_fused(failed)).all())


def _single_task(n, d=1, seed=5):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-4.0, 4.0, (n, d))
    y = np.sin(x).sum(1) + 0.1 * rs.randn(n)
    return x, y


@pytest.mark.parametrize("n,kernel", [(20, "mll_fwd"), (60, "blocked_fwd")])
def test_gpr_learner_on_card_matches_plain_cpu_learner(dev, n, kernel):
    """GPR-MLL with nets (16, 16), built without a device: 12 steps on the
    card through K2/K3 (N=20) or B4 (N=60), one launch a step each way, land
    within 1e-4 of the same steps on the CPU (plain versions); eval rtol
    1e-3."""
    from meta_learning_pacoh_torch import GPRegressionLearned

    x, y = _single_task(n, d=2 if n == 20 else 1)
    kw = dict(mean_nn_layers=(16, 16), kernel_nn_layers=(16, 16), random_seed=30)
    on_card = GPRegressionLearned(x, y, **kw)
    assert on_card.device.type == "cuda"
    on_cpu = GPRegressionLearned(x, y, device="cpu", **kw)
    cuda.reset_launch_counts()
    on_card.fit(n_iter=12, log_period=12, verbose=False)
    backward = kernel.replace("fwd", "bwd")
    assert {k: v for k, v in cuda.LAUNCHES.items() if v} == {kernel: 12, backward: 12}
    on_cpu.fit(n_iter=12, log_period=12, verbose=False)
    keep = torch.ones(on_cpu.params.numel(), dtype=torch.bool)
    keep[layout_slice(on_cpu.layout, ("kernel_nn", "b_out"))] = False
    assert float((on_card.params.cpu() - on_cpu.params)[keep].abs().max()) <= 1e-4
    np.testing.assert_allclose(on_card.eval(x, y), on_cpu.eval(x, y), rtol=1e-3, atol=1e-5)


def test_pac_learner_on_card_runs_k4_three_times_a_step(dev):
    """GPR-PAC at N=70 on the card: its KL's safe_cholesky runs K4 three
    times a step (two trials and the final factor) and nothing else; the
    first loss within 5e-2 of the CPU's (the prior Gram is singular to
    float32, so the two float32 orders part at the percent level), the
    parameters finite."""
    from meta_learning_pacoh_torch import GPRegressionLearnedPAC

    x, y = _single_task(70)
    kw = dict(mean_nn_layers=(16, 16), kernel_nn_layers=(16, 16), random_seed=30)
    on_card = GPRegressionLearnedPAC(x, y, **kw)
    on_cpu = GPRegressionLearnedPAC(x, y, device="cpu", **kw)
    cuda.reset_launch_counts()
    first = on_card.fit(n_iter=1, log_period=1, verbose=False)
    on_card.fit(n_iter=9, log_period=9, verbose=False)
    assert {k: v for k, v in cuda.LAUNCHES.items() if v} == {"chol": 30}
    assert first == pytest.approx(on_cpu.fit(n_iter=1, log_period=1, verbose=False), rel=5e-2)
    assert bool(torch.isfinite(on_card.params).all())


def test_custom_module_map_learner_on_card_takes_the_general_step(dev):
    """PACOH-MAP with MaternKernel(2.5) and LinearMean on 5 tasks of 60
    points: off the fused path, 10 general steps through B4 (one launch a
    step each way, no fused kernel), within 1e-4 of the CPU's plain steps."""
    from meta_learning_pacoh_torch import LinearMean, MaternKernel

    env = SinusoidDataset(random_state=np.random.RandomState(5))
    train = env.generate_meta_train_data(n_tasks=5, n_samples=60)
    kw = dict(covar_module=MaternKernel(2.5), mean_module=LinearMean(), task_batch_size=-1,
              random_seed=30)
    on_card = GPRegressionMetaLearned(train, **kw)
    assert not on_card._fused_path_ok()
    cuda.reset_launch_counts()
    on_card.meta_fit(n_iter=10, log_period=10, verbose=False)
    assert {k: v for k, v in cuda.LAUNCHES.items() if v} == {"blocked_fwd": 10,
                                                              "blocked_bwd": 10}
    on_cpu = GPRegressionMetaLearned(train, device="cpu", **kw)
    on_cpu.meta_fit(n_iter=10, log_period=10, verbose=False)
    assert float((on_card.params.cpu() - on_cpu.params).abs().max()) <= 1e-4


@pytest.mark.parametrize("learner", ["maml", "np"])
def test_maml_and_np_on_card_match_the_cpu(dev, learner):
    """MAML (nets (32, 32, 32, 32), second order, one inner step) and the NP
    (r = z = h = 50) on sin_20-like tasks, built without a device: on the
    card, with their tensors there and TF32 off; 20 steps from one state
    with the same draws (the step's draws come from a CPU generator, so
    both devices draw the same numbers) within 1e-4 max and 2e-6 mean of
    the same steps on the CPU, the last loss rtol 1e-5, no kernel launched;
    MAML's eval RMSE and the NP's eval metrics, with one set of latents fed
    to both, rtol 1e-4."""
    from meta_learning_pacoh_torch import MAMLRegression, NPRegressionMetaLearned

    env = SinusoidDataset(random_state=np.random.RandomState(26))
    train = env.generate_meta_train_data(n_tasks=20, n_samples=5)
    test = env.generate_meta_test_data(n_tasks=10, n_samples_context=5, n_samples_test=50)
    cls = MAMLRegression if learner == "maml" else NPRegressionMetaLearned
    on_card = cls(train, random_seed=30)
    assert on_card.device.type == "cuda" and on_card.params.is_cuda and on_card.X.is_cuda
    assert not torch.backends.cuda.matmul.allow_tf32
    on_cpu = cls(train, random_seed=30, device="cpu")
    on_cpu.load_state_dict(on_card.state_dict())
    cuda.reset_launch_counts()
    card_loss = on_card.meta_fit(n_iter=20, log_period=20, verbose=False)
    assert not any(cuda.LAUNCHES.values())
    cpu_loss = on_cpu.meta_fit(n_iter=20, log_period=20, verbose=False)
    d = (on_card.params.cpu() - on_cpu.params).abs()
    assert float(d.max()) <= 1e-4 and float(d.mean()) <= 2e-6
    assert card_loss == pytest.approx(cpu_loss, rel=1e-5)
    if learner == "np":
        eps = torch.randn(len(test), on_cpu.z_dim, generator=torch.Generator().manual_seed(0))
        on_card._eval_eps = lambda n: eps.to(dev)
        on_cpu._eval_eps = lambda n: eps
    np.testing.assert_allclose(on_card.eval_datasets(test), on_cpu.eval_datasets(test),
                               rtol=1e-4)


# ------------------------------------------------- the distributed tier (one NCCL rank)
@pytest.fixture
def nccl_mesh(dev):
    """A one-rank NCCL mesh of this process on the card (``make_mesh``'s
    single-process path)."""
    from meta_learning_pacoh_torch.parallel import make_mesh

    return make_mesh()


@pytest.mark.parametrize("n", [520, 1000, 2048])
def test_distributed_cholesky_one_rank(nccl_mesh, n):
    """distributed_cholesky over one NCCL rank (1000: the identity tail)
    against cholesky_ex: the factor within 1e-4 of L's largest entry,
    ||L L^T - A|| / ||A|| below 1e-5, and the diagonal blocks through K4."""
    from meta_learning_pacoh_torch.parallel import distributed_cholesky

    a = _psd(1, n, seed=n)[0].cuda()
    cuda.reset_launch_counts()
    L = distributed_cholesky(a, nccl_mesh)
    assert cuda.LAUNCHES["chol"] == -(-n // 128)
    ref, info = torch.linalg.cholesky_ex(a)
    assert int(info) == 0
    assert_close_per_system(L[None], ref[None])
    assert float(torch.linalg.norm(L @ L.T - a) / torch.linalg.norm(a)) < 1e-5


def test_distributed_gp_mll_one_rank(nccl_mesh):
    """distributed_gp_mll's value and closed-form gradient at N=1024 over one
    NCCL rank against the plain path's autograd (torch.linalg), both within
    1e-4 of a float64 plain run's largest entry."""
    from meta_learning_pacoh_torch.parallel import distributed_gp_mll

    n = 1024
    a = _psd(1, n, seed=3)[0].cuda()
    rs = np.random.RandomState(1)
    y = torch.tensor(rs.randn(n), dtype=torch.float32, device="cuda")
    mean = torch.tensor(rs.randn(n), dtype=torch.float32, device="cuda")

    def plain(m, k, yy):
        L = torch.linalg.cholesky(k)
        z = torch.linalg.solve_triangular(L, (yy - m)[:, None], upper=False)[:, 0]
        return -0.5 * (z @ z + 2 * torch.log(torch.diagonal(L)).sum() + n * math.log(2 * math.pi))

    def value_and_grads(fn, dtype):
        args = [t.to(dtype).requires_grad_(True) for t in (mean, a, y)]
        v = fn(*args)
        return [v.detach()] + list(torch.autograd.grad(v, args))

    got = value_and_grads(lambda m, k, yy: distributed_gp_mll(m, k, yy, nccl_mesh), torch.float32)
    f32 = value_and_grads(plain, torch.float32)
    f64 = value_and_grads(plain, torch.float64)
    for g, p, w in zip(got, f32, f64):
        scale = float(w.abs().max())
        assert float((g.double() - w).abs().max()) <= 1e-4 * scale
        assert float((p.double() - w).abs().max()) <= 1e-4 * scale
