"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device: a CUDA
kernel has no CPU mode. The file imports no JAX, so it also runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py -q -o addopts="" -m gpu

Errors are compared per system, relative to that system's largest |plain|
value, at rtol 1e-4 (float32 sums in another order; 1e-6 measured).
"""

import numpy as np
import pytest
import torch

from meta_learning_pacoh_torch import GPRegressionMetaLearnedSVGD
from meta_learning_pacoh_torch.datasets import CauchyDataset
from meta_learning_pacoh_torch.ops import cuda
from meta_learning_pacoh_torch.ops.cuda import chol_kernel, mll_kernel, svgd_kernel

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


@pytest.mark.parametrize("k", [4, 10, 32])
def test_svgd_kernel(dev, k):
    gen = torch.Generator().manual_seed(k)
    x = torch.randn(k, 2372, generator=gen).to(dev)
    s = torch.randn(k, 2372, generator=gen).to(dev)
    assert_close_per_system(svgd_kernel.svgd_phi_fused(x, s)[None],
                            svgd_kernel.svgd_phi_ref(x, s)[None])


@pytest.mark.parametrize("n", [9, 20, 48])
def test_mll_kernels_with_escalation(dev, n):
    rs = np.random.RandomState(n)
    kn = _psd(12, n, seed=n)
    kn[2] = _escalating(n, -5e-5, rs)
    kn[5] = _escalating(n, -5e-3, rs)
    kn, r = kn.to(dev), torch.tensor(rs.randn(12, n), dtype=torch.float32, device=dev)
    for got, want in zip(mll_kernel.mll_fwd(kn, r), mll_kernel.mll_fwd_ref(kn, r)):
        assert_close_per_system(got.reshape(12, -1), want.reshape(12, -1))
    _, _, L, z = mll_kernel.mll_fwd_ref(kn, r)
    gq = torch.tensor(rs.randn(12), dtype=torch.float32, device=dev)
    gl = torch.tensor(rs.randn(12), dtype=torch.float32, device=dev)
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
        assert_close_per_system(got.reshape(12, -1), want.reshape(12, -1))


@pytest.mark.parametrize("n", [70, 200, 300, 512])
def test_cholesky_kernel(dev, n):
    """N=300 and 512 factor in device memory instead of shared memory; the
    indefinite matrix 1 comes back all NaN in both."""
    a = _psd(4, n, seed=n).to(dev)
    a[1] -= 10.0 * torch.eye(n, device=dev)
    got, want = chol_kernel.cholesky_fused(a), chol_kernel.cholesky_ref(a)
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and bool(torch.isnan(got[1]).all())
    keep = [0, 2, 3]
    assert_close_per_system(got[keep], want[keep])


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


def test_learner_on_card_matches_plain_cpu_learner(dev):
    """Five steps and an eval on the card (K1-K4) against the same learner on
    the CPU (plain versions): particles within 1e-4 (the kernel net's output
    bias left out), metrics rtol 1e-3."""
    env = CauchyDataset(random_state=np.random.RandomState(5))
    train = env.generate_meta_train_data(n_tasks=4, n_samples=12)
    test = env.generate_meta_test_data(n_tasks=3, n_samples_context=12, n_samples_test=70)
    kw = dict(num_particles=4, mean_nn_layers=(8, 8), kernel_nn_layers=(8, 8), random_seed=30)
    on_card = GPRegressionMetaLearnedSVGD(train, device=dev, **kw)
    on_cpu = GPRegressionMetaLearnedSVGD(train, **kw)
    cuda.reset_launch_counts()
    for model in (on_card, on_cpu):
        model.meta_fit(n_iter=5, verbose=False)
    metrics_card, metrics_cpu = on_card.eval_datasets(test), on_cpu.eval_datasets(test)
    assert all(v > 0 for v in cuda.LAUNCHES.values()), cuda.LAUNCHES
    keep = torch.ones(on_cpu.hyper_prior.dim, dtype=torch.bool)
    keep[on_cpu.hyper_prior.slice_of(("kernel_nn", "b_out"))] = False
    diff = (on_card.particles.cpu() - on_cpu.particles)[:, keep].abs().max()
    assert float(diff) <= 1e-4
    np.testing.assert_allclose(metrics_card, metrics_cpu, rtol=1e-3, atol=1e-5)
